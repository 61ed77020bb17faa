"""Tensor-parallel core of the port: chunk planning (``coordination``), the
ring schedules (``primitives``), the collective backends (``backends``), the
dataflow optimizer (``dataflow``) and the period executor (``tp``).
Counterpart of ``repro/core``."""
