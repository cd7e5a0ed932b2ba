"""Host-side checks of the port's hot loops (port of the parts of
``repro.analysis`` that have a PyTorch counterpart): the host-sync guard
(``hostsync``) and kernel launch counts from ``torch.profiler``
(``launches``), which stand in for the reference's jaxpr and HLO walkers.
"""
