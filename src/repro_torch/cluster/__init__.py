"""Live edge nodes of the port, sketch-routed federated retrieval between
them, and the cluster runtime that schedules queries onto them (PPO
identification, Algorithm 1, SLO feedback) with trace replay, over
per-slot or standing queues."""
from repro_torch.cluster.federation import (CentroidSketch,  # noqa: F401
                                            FederatedRetriever,
                                            FederationStats,
                                            enable_federation)
from repro_torch.cluster.node import LiveEdgeNode, LiveNodeStats  # noqa: F401
from repro_torch.cluster.replay import (LiveWorkload,  # noqa: F401
                                        ReplayReport, autoscale_knobs,
                                        replay_trace)
from repro_torch.cluster.runtime import (ClusterRuntime,  # noqa: F401
                                         ClusterSlotMetrics)
