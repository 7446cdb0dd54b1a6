"""Context parallelism over the frame axis on torch.distributed
(vdn/parallel): the mesh, the launch, and the ring / Ulysses /
distributed-KV attentions."""
