"""`serve.encoder_graph_share` in VGGT-1B's serving cell: the share of
the encoder's inference forwards that replayed a CUDA graph, in %, read
by the same rule (`serve.encoder_graph_share.py`).  Nothing is read
where neither count moved: a program whose VGGT-1B forward bypasses the
graphs."""

import runpy
from pathlib import Path

read = runpy.run_path(
    str(Path(__file__).with_name("serve.encoder_graph_share.py")))["read"]
