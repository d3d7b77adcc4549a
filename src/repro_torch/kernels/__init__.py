"""Hand-written CUDA kernels of the vector engine's seams.

Each kernel has its source in ``csrc/``, is built at first use
(``build.py``) and has a wrapper beside its plain PyTorch version:

  * ``search``            (``search.py``)       replaces ``intersect_sorted``
  * ``merge_path``        (``merge.py``)        replaces ``merge_sorted``
  * ``multi_merge_ranks`` (``multi_merge.py``)  replaces ``multi_merge_ranks``

A wrapper launches its kernel for tensors on a CUDA device, takes the
plain version for tensors on the CPU, and counts its launches on its
``launches`` attribute.  ``backends.py`` lowers the five seams onto them.
"""
from .merge import merge_path, merge_path_plain
from .multi_merge import multi_merge_ranks, multi_merge_ranks_plain
from .search import search, search_plain

#: the wrappers whose ``launches`` counters a run reads
KERNELS = (search, merge_path, multi_merge_ranks)

__all__ = ["KERNELS", "merge_path", "merge_path_plain", "multi_merge_ranks",
           "multi_merge_ranks_plain", "search", "search_plain"]
