"""The paper's core modules, ported: the INR (``inr``) and the renderer
(``render``)."""
