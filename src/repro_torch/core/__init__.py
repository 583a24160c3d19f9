"""The scheduler of the port: queries and results, node capacity
functions and Algorithm 1, the PPO online identifier, the OCO intra-node
scheduler, the slot loop, and the simulated testbed that the paper's
evaluation runs on (latency and quality oracles, workloads, baselines);
ports and copies of ``repro/core``."""
