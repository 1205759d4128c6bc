"""repro_torch: the PyTorch / CUDA port of the DVNR framework.

A second package beside the JAX reference ``repro``: the same modules, names
and parameter layouts, written in PyTorch for an NVIDIA H100, with the TPU
kernels re-written by hand in CUDA C++ (``csrc/``). It imports nothing of
``repro`` or of JAX. It trains (``api.train``, with the non-finite retry
ladder on request), compresses models and keeps a temporal window of them,
serves frames (inference and rendering, through a brick cache or not),
extracts isosurfaces and traces pathlines, runs the reactive in situ loop
(``insitu.InSituSession``) under injected faults, and serves the inherited
LM stack, every family of it (``models.build_model``: prefill and decode).

- ``repro_torch.api``       ``train``, ``DVNRModel`` (init/from_state/
                            from_compressed/apply/decode_grid/compress/
                            save/load), ``render``, ``isosurface``,
                            ``trace_pathlines``, ``compress`` /
                            ``decompress``
- ``repro_torch.core``      the INR, the counter-based sampler, the trainer,
                            metrics, the renderer, the temporal model
                            cache, isosurfaces and pathlines
- ``repro_torch.reactive``  the lazy reactive graph and the DVNR node
- ``repro_torch.insitu``    the synthetic simulations, the actions and the
                            in situ session
- ``repro_torch.resilience`` fault plans, the recovery ladder, partition
                            sanitization
- ``repro_torch.compress``  the error-bounded codecs and model compression
                            (the JAX package's blobs, byte for byte)
- ``repro_torch.optim``     AdamW
- ``repro_torch.serving``   ``RenderService``: batched multi-client ticks in
                            front of the ``BrickCache``
- ``repro_torch.backends``  ``ref`` (plain PyTorch) / ``cuda`` (the kernels);
                            ``"auto"`` means the GPU and raises without one
- ``repro_torch.models``    the LM stack: layers, GQA attention, the
                            decoder-only transformer with dense or MoE
                            layers, Mamba2 and its LM, the hybrid, the
                            encoder-decoder, ``build_model``
- ``repro_torch.configs``   the DVNR presets and the ten LM arch configs
- ``repro_torch.kernels``   hash encode and fused MLP (forward and
                            backward), compositing, the fused train step and
                            AdamW, flash attention, each beside its plain
                            PyTorch version
- ``repro_torch.interop``   parameters, trainer states, LM parameters and
                            caches (every family's) to and from the JAX
                            package's numpy export
"""

__version__ = "0.1.0"
