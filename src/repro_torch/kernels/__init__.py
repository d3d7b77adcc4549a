"""Hand-written CUDA kernels of the port.

Each kernel has its source in ``csrc/``, is built at first use
(``build.py``) and has a wrapper beside its plain PyTorch version:

  * ``search``            (``search.py``)       replaces ``intersect_sorted``
  * ``merge_path``        (``merge.py``)        replaces ``merge_sorted``
  * ``multi_merge_ranks`` (``multi_merge.py``)  replaces ``multi_merge_ranks``
  * ``ssd_chunk``         (``ssd_chunk.py``)    replaces ``ssd_chunk``

A wrapper launches its kernel for tensors on a CUDA device, takes the
plain version for tensors on the CPU, and counts its launches on its
``launches`` attribute.  ``backends.py`` lowers the vector engine's five
seams onto the first three; ``models/ssm.py`` runs the fourth.
"""
from .merge import merge_path, merge_path_plain
from .multi_merge import multi_merge_ranks, multi_merge_ranks_plain
from .search import search, search_plain
from .ssd_chunk import ssd_chunk, ssd_chunk_plain

#: the simulator's seam kernels, whose ``launches`` counters a
#: simulation reads
KERNELS = (search, merge_path, multi_merge_ranks)
#: the model path's kernels, whose counters a prefill reads
MODEL_KERNELS = (ssd_chunk,)

__all__ = ["KERNELS", "MODEL_KERNELS", "merge_path", "merge_path_plain",
           "multi_merge_ranks", "multi_merge_ranks_plain", "search",
           "search_plain", "ssd_chunk", "ssd_chunk_plain"]
