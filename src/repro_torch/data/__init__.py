from repro_torch.data.graphs import (  # noqa: F401
    GraphData, chain_graph, load_edge_list, rmat_graph, save_edge_list,
    star_graph, uniform_graph,
)
