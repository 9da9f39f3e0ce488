"""Data parallelism over `torch.distributed`: process groups and launcher
environments (`distributed.py`), the device of a rank and the replicated
model (`mesh.py`), and the multi-process dry run (`dryrun.py`)."""
