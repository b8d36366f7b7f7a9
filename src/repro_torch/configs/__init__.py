"""CNN configs of the port (a copy of ``repro/configs/cnn.py``)."""
