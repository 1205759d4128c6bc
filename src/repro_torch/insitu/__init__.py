"""The in situ session (paper Fig. 5): simulation, reactive graph, actions."""
from repro_torch.insitu.actions import Action, isosurface_action, render_action
from repro_torch.insitu.session import InSituSession, StepRecord
from repro_torch.insitu.simulation import SimulationConfig, SyntheticSimulation

__all__ = ["Action", "isosurface_action", "render_action",
           "InSituSession", "StepRecord",
           "SimulationConfig", "SyntheticSimulation"]
