"""The paper's core modules, ported: the INR (``inr``), the counter-based
sampler (``sampling``), the trainer (``trainer``), metrics (``metrics``) and
the renderer (``render``)."""
