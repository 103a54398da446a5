"""Video list-file parsing.

The port's copy of vitta_tpu/data/records.py.  Reference: ``VideoRecord``
and ``_parse_list`` (models/tanet_models/video_dataset.py:12-27, 144-152).
Each row of a list file is ``"<relative path> <n_frames> <label>"``; rows
with fewer than 3 frames are filtered when requested; ``debug`` truncates
to the first ``debug_vid`` rows (utils/opts.py:66).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class VideoRecord:
    path: str
    num_frames: int
    label: int


def parse_list_file(list_file: str, min_frames: int = 3,
                    filter_short: bool = True,
                    debug: bool = False, debug_vid: int = 50) -> List[VideoRecord]:
    records = []
    with open(list_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 3:
                continue
            rec = VideoRecord(parts[0], int(parts[1]), int(parts[2]))
            if filter_short and rec.num_frames < min_frames:
                continue
            records.append(rec)
    if debug:
        records = records[:debug_vid]
    return records
