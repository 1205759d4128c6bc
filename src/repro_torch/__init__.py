"""repro_torch: the PyTorch / CUDA port of the DVNR framework.

A second package beside the JAX reference ``repro``: the same modules, names
and parameter layouts, written in PyTorch for an NVIDIA H100, with the TPU
kernels re-written by hand in CUDA C++ (``csrc/``). It imports nothing of
``repro`` or of JAX. It trains (``api.train``) and serves frames (inference
and rendering), and serves the inherited dense LM stack
(``models.build_model``: prefill and KV-cache decode).

- ``repro_torch.api``       ``train``, ``DVNRModel``
                            (init/from_state/apply/decode_grid/save/load)
                            and ``render``
- ``repro_torch.core``      the INR, the counter-based sampler, the trainer,
                            metrics and the renderer
- ``repro_torch.optim``     AdamW
- ``repro_torch.serving``   ``RenderService``: batched multi-client ticks
- ``repro_torch.backends``  ``ref`` (plain PyTorch) / ``cuda`` (the kernels);
                            ``"auto"`` means the GPU and raises without one
- ``repro_torch.models``    the LM stack: layers, GQA attention, the
                            decoder-only transformer, ``build_model``
- ``repro_torch.configs``   the DVNR presets and the ten LM arch configs
- ``repro_torch.kernels``   hash encode and fused MLP (forward and
                            backward), compositing, the fused train step and
                            AdamW, flash attention, each beside its plain
                            PyTorch version
- ``repro_torch.interop``   parameters, trainer states, LM parameters and KV
                            caches to and from the JAX package's numpy export
"""

__version__ = "0.1.0"
