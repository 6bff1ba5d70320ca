"""The import guard compares whole top-level names."""

import pytest

from harness import guard


@pytest.mark.parametrize('names,found', [
    (['nnest_torch', 'nnest_torch.samplers.nested', 'torch'], []),
    (['nnest_tpu'], ['nnest_tpu']),
    (['nnest_tpu.samplers.nested'], ['nnest_tpu']),
    (['jax.numpy', 'jaxlib.xla_client'], ['jax', 'jaxlib']),
    (['jaxtyping', 'flaxen', 'optaxx', 'nnest_tpux'], []),
    (['flax.linen', 'optax'], ['flax', 'optax']),
])
def test_forbidden_modules(names, found):
    assert guard.forbidden_modules(names) == found


def test_harness_and_reference_import_nothing_forbidden():
    """A fresh process that imports the harness, the reference and the
    metrics' readers loads nothing forbidden; the reference loads nothing
    of the program either."""
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "import reference.flow, reference.evidence, reference.replay\n"
        "import reference.consume, reference.likelihood\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == "
        "'nnest_torch')\n"
        "import glob, os\n"
        "from harness import cells, guard, bench\n"
        "[cells.reader(os.path.basename(p)[:-3]) for p in "
        "glob.glob(os.path.join(%r, 'metrics', '*.py'))]\n"
        "print(json.dumps([ref, guard.forbidden_modules()]))\n"
        % (here, os.path.dirname(here), here))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ref, found = json.loads(out.strip().splitlines()[-1])
    assert ref == [] and found == []


def test_tensorboard_takes_its_stub():
    import sys
    guard.keep_jax_out()
    assert 'tensorboard.compat.notf' in sys.modules
