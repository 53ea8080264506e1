import io
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def run_cell():
    """Run a cell at the tiny sizes of ``tiny.py``, on the CPU unless
    ``device=None`` (the card); returns the result's dict (the last line
    the harness printed)."""
    from perfbench import harness
    from perfbench.tests.tiny import OVERRIDES

    def go(name, seed=123456789012, seconds=1.0, trace=False, control=None, root=ROOT,
           overrides=None, device="cpu"):
        out, err = io.StringIO(), io.StringIO()
        over = overrides if overrides is not None else OVERRIDES[name]
        return harness.run(root, name, seed, seconds, trace, device=device, overrides=over,
                           control=control, out=out, err=err)

    return go


@pytest.fixture
def cuda_device():
    """Skips a test that needs a card where none is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
