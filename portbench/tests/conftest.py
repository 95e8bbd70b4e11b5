import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU runs here are tiny; one intra-op thread a test process keeps
# several workers from oversubscribing the cores and starving the windows
import torch  # noqa: E402

torch.set_num_threads(1)
