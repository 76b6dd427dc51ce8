"""Host-side transform matrices (numpy, float32).

The rotation matrices reproduce the reference's element layout
(src/matrix.cu:119-135): the X/Y rotations are the transpose of the usual
convention. Scene geometry and camera bases depend on it.
"""

from __future__ import annotations

import numpy as np

X_AXIS = 0
Y_AXIS = 1
Z_AXIS = 2


def enlargement_matrix(scale: float, dims: int = 3) -> np.ndarray:
    """Uniform scale matrix (reference: src/matrix.cu:74-96)."""
    return np.eye(dims, dtype=np.float32) * np.float32(scale)


def rotation_matrix(axis: int, angle: float) -> np.ndarray:
    """Axis rotation with the reference's exact layout (src/matrix.cu:119-135)."""
    s = np.float32(np.sin(angle))
    c = np.float32(np.cos(angle))
    if axis == X_AXIS:
        m = [[1, 0, 0], [0, c, s], [0, -s, c]]
    elif axis == Y_AXIS:
        m = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    elif axis == Z_AXIS:
        m = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    else:
        raise ValueError(f"bad axis {axis}")
    return np.array(m, dtype=np.float32)


def rotate_xyz(x_angle: float, y_angle: float, z_angle: float) -> np.ndarray:
    """Rx @ Ry @ Rz, the composition order of both mesh rotation
    (src/obj_read.cu:66-75) and the camera basis (src/camera.cu:63-69)."""
    return (
        rotation_matrix(X_AXIS, x_angle)
        @ rotation_matrix(Y_AXIS, y_angle)
        @ rotation_matrix(Z_AXIS, z_angle)
    ).astype(np.float32)
