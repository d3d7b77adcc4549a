"""Hand-written CUDA kernels of the port.

Each kernel has its source in ``csrc/``, is built at first use
(``build.py``) and has a wrapper beside its plain PyTorch version:

  * ``search``              (``search.py``)       replaces ``intersect_sorted``
  * ``merge_path``          (``merge.py``)        replaces ``merge_sorted``
  * ``multi_merge_ranks``   (``multi_merge.py``)  replaces ``multi_merge_ranks``
  * ``ssd_chunk``           (``ssd_chunk.py``)    replaces ``ssd_chunk``
  * ``ssd_chunk_bwd``       (``ssd_chunk_bwd.py``) its gradient, which
                            the reference's kernel lacks
  * ``flash_attention``     (``flash_attention.py``) replaces
                            ``flash_attention``
  * ``flash_attention_bwd`` (``flash_attention_bwd.py``) its gradient,
                            which the reference's kernel lacks
  * ``block_sparse_matmul`` (``block_sparse_matmul.py``) replaces
                            ``block_sparse_matmul``

A wrapper launches its kernel for tensors on a CUDA device, takes the
plain version for tensors on the CPU, and counts its launches on its
``launches`` attribute.  The model kernels' wrappers (the last five)
also take tensors on the ``meta`` device: they return empty outputs and
report the call's operations and bytes (their module's ``flops`` and
``nbytes``) to a dry run's counter (``meta.py``).
``backends.py`` lowers the vector engine's five seams onto the first
three; ``models/ssm.py`` runs the fourth (and,
under autograd, its gradient), ``models/layers.py`` the flash attention
(and, under autograd, its gradient), and
``bench/kernels_bench.py`` the six forward kernels.
``ref.py`` holds the oracles of the last three.
"""
from .block_sparse_matmul import (block_sparse_matmul,
                                  block_sparse_matmul_dense_a,
                                  block_sparse_matmul_plain, compact_tiles)
from .flash_attention import (FlashAttention, flash_attention,
                              flash_attention_lse_plain,
                              flash_attention_plain)
from .flash_attention_bwd import (flash_attention_bwd,
                                  flash_attention_bwd_plain)
from .merge import merge_path, merge_path_plain
from .multi_merge import multi_merge_ranks, multi_merge_ranks_plain
from .search import search, search_plain
from .ssd_chunk import SsdChunk, ssd_chunk, ssd_chunk_plain
from .ssd_chunk_bwd import ssd_chunk_bwd, ssd_chunk_bwd_plain

#: the simulator's seam kernels, whose ``launches`` counters a
#: simulation reads
KERNELS = (search, merge_path, multi_merge_ranks)
#: the model path's kernels, whose counters a prefill or a train step reads
MODEL_KERNELS = (ssd_chunk, flash_attention, flash_attention_bwd,
                 ssd_chunk_bwd)

__all__ = ["FlashAttention", "KERNELS", "MODEL_KERNELS", "SsdChunk",
           "block_sparse_matmul", "block_sparse_matmul_dense_a",
           "block_sparse_matmul_plain", "compact_tiles", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_lse_plain", "flash_attention_plain",
           "merge_path", "merge_path_plain", "multi_merge_ranks",
           "multi_merge_ranks_plain", "search", "search_plain", "ssd_chunk",
           "ssd_chunk_bwd", "ssd_chunk_bwd_plain", "ssd_chunk_plain"]
