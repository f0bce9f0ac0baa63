"""Step builders and the serving driver of the port's language model, the
counterparts of the reference package's ``launch/steps.py`` and
``launch/serve.py`` (one card, no mesh)."""
