"""The plain fp32 reference of the benchmark's configurations: DeepLabV3+'s
model (``model.py``) and its tensors and units (``arch.py``), which
``families/deeplabv3p.py`` serves; the lower-precision hooks every family's
forward takes (``quant.py``); and the training step (``train.py``).  It
imports nothing of the program."""
