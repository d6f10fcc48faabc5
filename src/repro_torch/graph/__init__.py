"""Graphs on the device: CSR storage, DAG orientation and generators
(counterpart of ``repro.graph``)."""
from repro_torch.graph.csr import CSRGraph, build_csr, from_edge_list
from repro_torch.graph.dag import orient_dag
from repro_torch.graph import generators
