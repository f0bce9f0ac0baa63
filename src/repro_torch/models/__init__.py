"""The language model of the port, every family of the repo's configs:
``config``, ``layers``, ``moe``, ``mamba``, ``model``.  The counterpart of
the reference package's ``models/``."""
