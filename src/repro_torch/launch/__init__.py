"""Launchers of the port: ``python -m repro_torch.launch.serve`` runs
request waves over the serving engine, ``python -m
repro_torch.launch.cluster_serve`` builds the live edge cluster and
replays a trace through the hierarchical scheduler, and ``python -m
repro_torch.launch.train`` trains on random batches, as their ``repro``
counterparts do; ``python -m repro_torch.launch.train_tiny`` is the
port's ``examples/train_tiny.py``, whose checkpoint ``cluster_serve
--ckpt`` serves."""
