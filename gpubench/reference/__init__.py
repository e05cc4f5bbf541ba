"""The plain reference of the benchmarked models, in float32 PyTorch with
TF32 off: the model (``model.py``), three training steps with Adam
(``train.py``) and the judge of greedy decodes (``decode.py``).  It imports
nothing of the port and takes nothing the port made: the harness hands it
the weights and the utterances it made itself."""
