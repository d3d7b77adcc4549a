"""Hand-written CUDA kernels of the port.

Each kernel has its source in ``csrc/``, is built at first use
(``build.py``) and has a wrapper beside its plain PyTorch version:

  * ``search``              (``search.py``)       replaces ``intersect_sorted``
  * ``merge_path``          (``merge.py``)        replaces ``merge_sorted``
  * ``multi_merge_ranks``   (``multi_merge.py``)  replaces ``multi_merge_ranks``
  * ``ssd_chunk``           (``ssd_chunk.py``)    replaces ``ssd_chunk``
  * ``flash_attention``     (``flash_attention.py``) replaces
                            ``flash_attention``
  * ``block_sparse_matmul`` (``block_sparse_matmul.py``) replaces
                            ``block_sparse_matmul``

A wrapper launches its kernel for tensors on a CUDA device, takes the
plain version for tensors on the CPU, and counts its launches on its
``launches`` attribute.  ``backends.py`` lowers the vector engine's five
seams onto the first three; ``models/ssm.py`` runs the fourth,
``models/layers.py`` the fifth, and ``bench/kernels_bench.py`` all six.
``ref.py`` holds the oracles of the last three.
"""
from .block_sparse_matmul import (block_sparse_matmul,
                                  block_sparse_matmul_dense_a,
                                  block_sparse_matmul_plain, compact_tiles)
from .flash_attention import flash_attention, flash_attention_plain
from .merge import merge_path, merge_path_plain
from .multi_merge import multi_merge_ranks, multi_merge_ranks_plain
from .search import search, search_plain
from .ssd_chunk import ssd_chunk, ssd_chunk_plain

#: the simulator's seam kernels, whose ``launches`` counters a
#: simulation reads
KERNELS = (search, merge_path, multi_merge_ranks)
#: the model path's kernels, whose counters a prefill reads
MODEL_KERNELS = (ssd_chunk, flash_attention)

__all__ = ["KERNELS", "MODEL_KERNELS", "block_sparse_matmul",
           "block_sparse_matmul_dense_a", "block_sparse_matmul_plain",
           "compact_tiles", "flash_attention", "flash_attention_plain",
           "merge_path", "merge_path_plain", "multi_merge_ranks",
           "multi_merge_ranks_plain", "search", "search_plain", "ssd_chunk",
           "ssd_chunk_plain"]
