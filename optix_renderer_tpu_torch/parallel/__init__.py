"""Multiple devices and processes: the sharded render and train step
(`shard.py`) and their multi-process form on `torch.distributed`
(`multihost.py`, rehearsed by `mh_worker.py`)."""
