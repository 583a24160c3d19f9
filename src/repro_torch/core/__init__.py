"""The scheduler of the port: queries and results, node capacity
functions and Algorithm 1, the PPO online identifier and the slot loop
(ports and copies of ``repro/core``).  The simulated cluster path
(latency and quality oracles, the intra-node scheduler, baselines) is
not ported yet."""
