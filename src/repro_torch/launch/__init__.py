"""Entry points of the port (one card, no mesh): the language model's step
builders and serving driver (``launch/steps.py``, ``launch/serve.py``),
the CT training subsystem (``launch/ct_train.py``) and CT serving
(``launch/ct_serve.py``), the counterparts of the reference package's
modules of the same names."""
