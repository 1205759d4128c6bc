"""Hand-written CUDA kernels (``repro_torch/csrc``) with their plain PyTorch
versions. Each op package holds ``ref.py`` (the plain version) and ``ops.py``
(dispatch plus the kernel's wrapper, whose ``launches`` attribute counts the
kernel launches it made). ``build.py`` compiles and loads the kernels."""
