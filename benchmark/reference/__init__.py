"""The plain fp32 reference of the benchmark's configurations: the model
(``model.py``), its tensors and units (``arch.py``) and its training step
(``train.py``).  It imports nothing of the program."""
