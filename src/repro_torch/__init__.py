"""PyTorch port of the TeAAL simulator's vector path.

``repro_torch.accelerators.simulate`` runs a design on real tensors:
the host-side fibertree / CSF machinery, the VectorBackend frontier
execution, and its kernel seams, which run on the CUDA device through
hand-written kernels (``repro_torch.kernels``) -- or, with
``device='cpu'``, through their plain PyTorch versions.  The kernels are
built at first use, so importing the package needs no card.
"""
