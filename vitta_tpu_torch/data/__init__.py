"""The port's data layer: list files, frame samplers, the native host
library, video sources, datasets and a pinned-memory ``Prefetcher``.

Importing it loads neither PIL nor decord (the card's machine has
neither) and builds nothing: the host libraries build with ``g++`` at
their first call.
"""

from vitta_tpu_torch.data.records import VideoRecord, parse_list_file  # noqa: F401
from vitta_tpu_torch.data import sampling  # noqa: F401
