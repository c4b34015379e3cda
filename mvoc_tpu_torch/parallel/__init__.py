"""Multi-device execution on torch.distributed: the (job, seq, model) mesh
(`mesh.py`) and the collectives over its axes (`collectives.py`)."""
