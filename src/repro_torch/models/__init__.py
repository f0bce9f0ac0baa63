"""The language model of the port (dense family): ``config``, ``layers``,
``model``.  The counterpart of the reference package's ``models/``."""
