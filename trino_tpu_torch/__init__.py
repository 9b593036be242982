"""trino_tpu_torch — the PyTorch/CUDA port of trino_tpu.

A second package beside ``trino_tpu`` (the JAX reference, which it never
imports): the same SQL front end and planner (copies), with the device
layer rewritten on torch tensors and the TPU's Pallas kernels rewritten by
hand for NVIDIA Hopper (``csrc/``, built with nvcc at first use).

Entry point: ``trino_tpu_torch.exec.session.Session`` — runs on ``cuda``
unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
