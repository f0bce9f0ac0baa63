"""Run-time services of the port: atomic checkpoints
(``runtime/checkpoint.py``)."""
