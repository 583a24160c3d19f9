"""Serving stack of the port: a paged continuous-batching engine, sampling
parameters, the shared-prefix cache and the ``ContinuousQueue`` scheduler.

    from repro_torch.serving import ServeEngine, GenerationParams
    from repro_torch.serving import ContinuousQueue
"""
from repro_torch.serving.engine import ContinuousSession, ServeEngine
from repro_torch.serving.sampling import GenerationParams, sample_token
from repro_torch.serving.scheduler import (ContinuousCompletion,
                                           ContinuousQueue, ContinuousStats,
                                           RequestQueue)

__all__ = ["ServeEngine", "ContinuousSession", "GenerationParams",
           "sample_token", "RequestQueue", "ContinuousCompletion",
           "ContinuousQueue", "ContinuousStats"]
