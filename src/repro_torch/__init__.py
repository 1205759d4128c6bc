"""repro_torch: the PyTorch / CUDA port of the DVNR framework.

A second package beside the JAX reference ``repro``: the same modules, names
and parameter layouts, written in PyTorch for an NVIDIA H100, with the TPU
kernels of the path re-written by hand in CUDA C++ (``csrc/``). It imports
nothing of ``repro`` or of JAX. This slice serves frames (inference and
rendering); training comes with the next one.

- ``repro_torch.api``       ``DVNRModel`` (init/apply/decode_grid/save/load)
                            and ``render``
- ``repro_torch.serving``   ``RenderService``: batched multi-client ticks
- ``repro_torch.backends``  ``ref`` (plain PyTorch) / ``cuda`` (the kernels);
                            ``"auto"`` means the GPU and raises without one
- ``repro_torch.kernels``   hash encode, fused MLP and compositing kernels,
                            each beside its plain PyTorch version
- ``repro_torch.interop``   parameters to and from the JAX package's numpy
                            export
"""

__version__ = "0.1.0"
