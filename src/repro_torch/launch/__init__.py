"""Launchers of the port: ``python -m repro_torch.launch.serve`` runs
request waves over the serving engine, and ``python -m
repro_torch.launch.cluster_serve`` builds the live edge cluster and
replays a trace through the hierarchical scheduler, as their ``repro``
counterparts do."""
