"""Hand-written Hopper kernels of the port and the plumbing around them.

``conflict``, ``kv_commit`` and ``fused_adamw`` hold the kernel wrappers
(CUDA kernels in ``csrc/``, built at first use by ``_build``), ``ref``
their plain PyTorch versions, ``validate`` the address-set packing and
``ops`` the conflict-table updates the round protocol calls, the paged
commit the serving session calls and the AdamW commit the optimizer
calls.
"""
