"""The benchmark harness of ``raytracer_tpu_torch``.

``spec`` finds a cell's files by the names in ``BENCHMARK.json``;
``modes`` drives the program's own loops through a measured window;
``profile`` reduces the traced window's device events; ``stats`` holds the metric arithmetic;
``check`` compares what the window produced with the plain reference in
``pbref``; ``cell`` runs one cell end to end.
"""
