"""Target-list parsing shared by the detect/merge stages.

A target list line is ``specimen/file[,width,height,objective,downsample,
mpp_x,mpp_y]`` — the metadata tail is present for PNG inputs whose slide
metadata cannot be read from the image itself
(ref ``detect_glomus_test.py:113-129``, ``merge_overlaped_glomus.py:64-93``).
Lines whose specimen id starts with ``#`` are comments.

The port's own copy of ``glomeruli_segmentation_tpu/utils/target_list.py``
(the port imports nothing of the JAX package); a test holds the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class TargetMetadata:
    org_slide_width: int = 0
    org_slide_height: int = 0
    org_slide_objective_power: float = 0.0
    slide_downsample: float = 0.0
    mpp_x: float = 0.0
    mpp_y: float = 0.0


@dataclass
class TargetEntry:
    specimen_id: str
    file_name: str
    metadata: TargetMetadata
    is_comment: bool = False


def parse_target_line(line: str) -> Optional[TargetEntry]:
    line = line.strip()
    if not line:
        return None
    parts = line.split(",")
    if len(parts) < 7:
        meta = TargetMetadata()
    else:
        meta = TargetMetadata(
            org_slide_width=int(parts[1]),
            org_slide_height=int(parts[2]),
            org_slide_objective_power=float(parts[3]),
            slide_downsample=float(parts[4]),
            mpp_x=float(parts[5]),
            mpp_y=float(parts[6]),
        )
    path_parts = parts[0].split("/")
    specimen_id = path_parts[0]
    file_name = path_parts[1] if len(path_parts) > 1 else ""
    return TargetEntry(specimen_id, file_name, meta,
                       is_comment=specimen_id.startswith("#"))


def read_target_list(path: str) -> List[TargetEntry]:
    entries = []
    with open(path) as f:
        for line in f:
            entry = parse_target_line(line)
            if entry is not None:
                entries.append(entry)
    return entries


def metadata_by_file_id(path: str) -> Dict[str, TargetMetadata]:
    """file id (second path component) -> metadata, as the merger expects."""
    return {e.file_name: e.metadata for e in read_target_list(path)}
