"""Graph neural networks (counterpart of ``repro.models.gnn``): GAT and
GraphSAGE, and the equivariant potentials NequIP and EquiformerV2 over
the shared substrate in ``equivariant``.  Their message passing sums on
the segment-sum kernel through ``repro_torch.sparse.ops.segment_sum``."""
