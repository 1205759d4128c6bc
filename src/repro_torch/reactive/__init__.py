"""The reactive runtime (paper §IV): the lazy graph and the DVNR node."""
from repro_torch.reactive.graph import Node, Runtime, SlidingWindow, Source, Trigger
from repro_torch.reactive.dvnr import DVNRValue, dvnr_node

__all__ = ["Node", "Runtime", "SlidingWindow", "Source", "Trigger",
           "DVNRValue", "dvnr_node"]
