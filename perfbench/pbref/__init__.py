"""The benchmark's plain reference of the path tracer.

Plain PyTorch and NumPy, written from the semantics of the upstream
renderer (Ben-Edwards44/Ray-Tracer) as the port states them: the same
scene primitives, camera, random streams, intersection, shading and
accumulation. It imports nothing of the program under test and takes
nothing the program made: it builds its scenes, rays and keys
itself from the configuration files and the seed. It reads the program's
outputs only to judge them.

Every float computation takes a ``dtype``: float32 is the reference,
bfloat16 the precision control that must fail the comparison.
"""
