"""Run-time services of the port: atomic checkpoints
(``runtime/checkpoint.py``), fault handling (``runtime/fault.py``) and 1-bit
gradient compression (``runtime/compression.py``)."""
