"""Input-shape cell: twin of ``repro.configs.shapes.ShapeSpec``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
