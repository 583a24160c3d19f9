"""Serving stack of the port: the engine (``generate`` /
``generate_reference`` waves, and continuous sessions over a contiguous
or a paged cache), sampling parameters, the shared-prefix cache and two
request schedulers: synchronous ``RequestQueue`` waves and
``ContinuousQueue`` continuous batching (``standing=True`` keeps one live
session across ``run()`` calls).

    from repro_torch.serving import ServeEngine, GenerationParams, RequestQueue
    from repro_torch.serving import ContinuousQueue
"""
from repro_torch.serving.engine import ContinuousSession, ServeEngine
from repro_torch.serving.sampling import GenerationParams, sample_token
from repro_torch.serving.scheduler import (Completion, ContinuousCompletion,
                                           ContinuousQueue, ContinuousStats,
                                           QueueStats, RequestQueue)

__all__ = ["ServeEngine", "ContinuousSession", "GenerationParams",
           "sample_token", "Completion", "QueueStats", "RequestQueue",
           "ContinuousCompletion", "ContinuousQueue", "ContinuousStats"]
