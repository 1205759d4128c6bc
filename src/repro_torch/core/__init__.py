"""The paper's core modules, ported: the INR (``inr``), the counter-based
sampler (``sampling``), the trainer (``trainer``), metrics (``metrics``),
the renderer (``render``), the temporal model cache (``temporal``),
isosurfaces (``isosurface``) and pathlines (``pathlines``)."""
