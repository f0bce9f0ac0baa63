"""Entry points of the port (one card, no mesh): the language model's step
builders and serving driver (``launch/steps.py``, ``launch/serve.py``) and
the CT training subsystem (``launch/ct_train.py``), the counterparts of the
reference package's modules of the same names."""
