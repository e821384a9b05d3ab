"""Body-part labels: template part lists + 1-NN label transfer by matmul.

Re-design of PartRecognition/PartRecognition.{h,cpp}: the 16-part enum
(PartRecognition.h:13-30), the ``Name=i;j;k;...`` part-file parser
(LoadParts, PartRecognition.cpp:7-48, data format Template/part/parts), and
PartRecog's per-point FLANN kd-tree 1-NN (PartRecognition.cpp:50-77) —
replaced by chunked brute-force min-distance (distance matrix =
one matmul per chunk), which is exact (FLANN is approximate) and batched.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp

# part ids follow PartRecognition.h:13-30 exactly
HEAD, NECK = 0, 1
LEFT_UPPER_ARM, LEFT_LOWER_ARM, LEFT_HAND = 2, 3, 4
RIGHT_UPPER_ARM, RIGHT_LOWER_ARM, RIGHT_HAND = 5, 6, 7
LEFT_THIGH, LEFT_SHANK, LEFT_FOOT = 8, 9, 10
RIGHT_THIGH, RIGHT_SHANK, RIGHT_FOOT = 11, 12, 13
TRUNCUS, HIP = 14, 15

PART_NAMES: Dict[str, int] = {
    "Head": HEAD, "Neck": NECK,
    "LeftUpperArm": LEFT_UPPER_ARM, "LeftLowerArm": LEFT_LOWER_ARM,
    "LeftHand": LEFT_HAND,
    "RightUpperArm": RIGHT_UPPER_ARM, "RightLowerArm": RIGHT_LOWER_ARM,
    "RightHand": RIGHT_HAND,
    "LeftThigh": LEFT_THIGH, "LeftShank": LEFT_SHANK, "LeftFoot": LEFT_FOOT,
    "RightThigh": RIGHT_THIGH, "RightShank": RIGHT_SHANK,
    "RightFoot": RIGHT_FOOT,
    "Truncus": TRUNCUS, "Hip": HIP,
}

NUM_PARTS = 16

# 16 distinct display colors for part visualization (debug OBJ export,
# PartRecognition.cpp:79-107 analogue)
PART_COLORS = np.asarray([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [170, 110, 40],
    [128, 0, 0], [128, 128, 0], [0, 0, 128], [128, 128, 128],
], np.float32) / 255.0


def load_parts(path: str, num_vertices: int) -> np.ndarray:
    """Parse the reference's part file: lines ``Name=i;j;k;...`` assigning
    template vertex indices to parts (LoadParts, PartRecognition.cpp:7-48).
    Unlisted vertices default to part 0 (HEAD), as in the reference
    (parts.resize default-initializes to 0)."""
    labels = np.zeros(num_vertices, np.int32)
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            name, _, rest = line.partition("=")
            pid = PART_NAMES.get(name.strip())
            if pid is None:
                continue
            for tok in rest.split(";"):
                tok = tok.strip()
                if tok:
                    labels[int(tok)] = pid
    return labels


def save_parts(path: str, labels: np.ndarray):
    """Write labels back in the reference format (one line per part)."""
    inv = {v: k for k, v in PART_NAMES.items()}
    with open(path, "w") as f:
        for pid in range(NUM_PARTS):
            idx = np.nonzero(labels == pid)[0]
            if len(idx):
                f.write(f"{inv[pid]}=" + ";".join(map(str, idx)) + "\n")


@partial(jax.jit, static_argnames=())
def _nn_chunk(query, ref):
    """Nearest ref index for each query point; distance matrix via matmul."""
    # |q - r|^2 = |q|^2 - 2 q.r + |r|^2 ; argmin over r
    # K=3 contraction: full-precision operands are free here, and the
    # |q|^2-2qr+|r|^2 cancellation amplifies reduced-precision (bf16/TF32)
    # operand rounding enough to flip close 1-NN decisions
    qr = jnp.dot(query, ref.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    d2 = (jnp.sum(query * query, -1, keepdims=True) - 2.0 * qr +
          jnp.sum(ref * ref, -1)[None, :])
    return jnp.argmin(d2, axis=1)


def nearest_neighbor_indices(query: jnp.ndarray, ref: jnp.ndarray,
                             chunk: int = 8192) -> np.ndarray:
    """Exact 1-NN indices of query [M,3] into ref [N,3], chunked matmuls."""
    out = []
    q = jnp.asarray(query, jnp.float32)
    r = jnp.asarray(ref, jnp.float32)
    for c in range(0, q.shape[0], chunk):
        out.append(np.asarray(_nn_chunk(q[c:c + chunk], r)))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def part_recog(template_points, template_labels, scan_points,
               chunk: int = 8192) -> np.ndarray:
    """Transfer template part labels to scan points by exact 1-NN
    (PartRecog, PartRecognition.cpp:50-77)."""
    idx = nearest_neighbor_indices(scan_points, template_points, chunk)
    return np.asarray(template_labels)[idx]


def visualize_parts(path: str, points: np.ndarray, labels: np.ndarray):
    """Colored-point OBJ export (Visualization, PartRecognition.cpp:79-107)."""
    from ..io.meshio import write_obj
    colors = PART_COLORS[np.asarray(labels) % NUM_PARTS]
    write_obj(path, points, None, None, colors=colors)


def load_shoulder_joints(path: str) -> Dict[str, List[int]]:
    """Parse Template/ShoulderJoint: per-side annotated joint vertex lists
    (LoadShoulderJoints, PartRecognition.cpp:110-138). Format mirrors the
    part file: ``Left=...`` / ``Right=...`` index lists."""
    out: Dict[str, List[int]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            name, _, rest = line.partition("=")
            out[name.strip()] = [int(t) for t in rest.split(";") if t.strip()]
    return out
