"""Launchers of the port: ``python -m repro_torch.launch.cluster_serve``
builds the live edge cluster and replays a trace through the
hierarchical scheduler, as ``repro.launch.cluster_serve`` does."""
