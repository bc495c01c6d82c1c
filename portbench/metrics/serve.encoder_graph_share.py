"""The share of the encoder's inference forwards that replayed a CUDA
graph (`ops/cuda_lib.py:launch_counts`, "encoder_graph_replay" over it
and "encoder_graph_eager", a traced item's), in %.  Nothing is read
where neither count moved: training, or a program without the graphs."""


def read(r):
    replay = r.launches.get("encoder_graph_replay", 0)
    eager = r.launches.get("encoder_graph_eager", 0)
    if r.kind != "serve" or replay + eager <= 0:
        return None
    return 100.0 * replay / (replay + eager)
