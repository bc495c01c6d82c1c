"""The encoder's inference forward, replayed as CUDA graphs.

`EncoderGraphs` runs the encoder's network `fn(*args)` (tensors or None
in, a tuple of tensors or None out) as one `torch.cuda.CUDAGraph` launch
instead of its thousands of small kernel launches.  It captures one graph
per input signature (each argument's shape, dtype and device, and the
settings that change the captured work: `attention.FLASH_MIN_KV` and the
two TF32 flags) and replays it on every later call with that signature:

- the first call of a signature runs `fn` eagerly on a side stream and
  returns that result: the warm-up that capture needs (cuBLAS and cuDNN
  set up their workspaces, the port's kernels load and raise their
  shared-memory limits).  The capture follows it;
- a replay copies the inputs into the graph's own buffers, launches the
  graph and clones its outputs, so nothing returned aliases the memory
  that the next replay overwrites.

`cuda_lib.launch_counts` counts both kinds of call: `encoder_graph_eager`
and `encoder_graph_replay`.  The kernel wrappers count the warm-up's
launches and those the capture records; a replay calls no wrapper, so the
kernels it launches show in a device trace only.  The graphs and their
memory pools live as long as the cache.

`models/encoder_base.py:GraphedEncoder` is the encoders' side of it (the
flagship's and VGGT-1B's): when `_network` takes the graphs, and the
cache's lifecycle on the module.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.ops import attention, cuda_lib
from spfsplatv2_tpu_torch.utils.profiling import span


class EncoderGraphs:
    def __init__(self):
        self._graphs: dict = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, fn, args: tuple) -> tuple:
        """fn(*args), from a replay of its graph where one was captured
        for this signature."""
        key = (tuple(None if a is None else (tuple(a.shape), a.dtype, a.device)
                     for a in args),
               attention.FLASH_MIN_KV, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        device = next(a.device for a in args if a is not None)
        entry = self._graphs.get(key)
        with torch.cuda.device(device):
            if entry is None:
                out, self._graphs[key] = _warm_up_and_capture(fn, args)
                cuda_lib.launch_counts["encoder_graph_eager"] += 1
                return out
            static_in, graph, static_out = entry
            with span("encoder.graph"):
                for buf, a in zip(static_in, args):
                    if buf is not None:
                        buf.copy_(a)
                graph.replay()
                out = tuple(None if t is None else t.clone()
                            for t in static_out)
        cuda_lib.launch_counts["encoder_graph_replay"] += 1
        return out


def _warm_up_and_capture(fn, args: tuple):
    """-> (fn(*args) run eagerly, (static inputs, graph, static outputs))."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*args)
    main.wait_stream(side)
    for t in out:
        if t is not None:
            t.record_stream(main)
    static_in = tuple(None if a is None else a.clone() for a in args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(*static_in)
    return out, (static_in, graph, static_out)
