"""Checks of the port's programs (port of ``repro.analysis``): the
host-sync guard (``hostsync``), kernel launch counts from
``torch.profiler`` (``launches``), and the lint gate (``passes``,
``executables``, ``lint``; CLI ``launch/lint.py``), whose passes read one
eager run of each executable where the reference reads its jaxpr and
compiled HLO (``hlo.py`` and ``jaxprs.py`` have no counterpart).
"""
