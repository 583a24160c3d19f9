"""Live edge nodes of the port and sketch-routed federated retrieval
between them.  The cluster runtime, trace replay and standing engines of
``repro.cluster`` are not ported yet."""
from repro_torch.cluster.federation import (CentroidSketch,  # noqa: F401
                                            FederatedRetriever,
                                            FederationStats,
                                            enable_federation)
from repro_torch.cluster.node import LiveEdgeNode, LiveNodeStats  # noqa: F401
