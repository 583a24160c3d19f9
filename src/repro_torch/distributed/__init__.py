"""The distributed layer of the port on ``torch.distributed``
(counterparts of ``repro/distributed/*``): sharding rules
(``sharding``), the corpus-sharded top-k and the sequence-sharded decode
(``collectives``), expert-parallel MoE (``expert_parallel``), the
sharded program of every arch, tensor parallelism and FSDP
(``tensor_parallel``), and the mesh axis helpers they share
(``_compat``).  Importing it starts no process group."""
