"""rcmarl_tpu_torch — the PyTorch and CUDA port of ``rcmarl_tpu``.

A second package beside the JAX one, ported slice by slice; each module
mirrors the JAX module of the same name. The port imports ``torch`` and
never ``jax`` or ``rcmarl_tpu``. Its entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
