"""The Zoo compose layer (the port's copy of the JAX package's
``core/``): typed services (``service``), compatibility checking
(``compat``), combinators (``compose``), the model zoo (``registry``,
``transport``), deployment (``deploy``, ``netmodel``), per-stage
profiling (``profile``) and the model-backed services
(``zoo_builders``)."""
