"""The port stands alone: lerc_tpu_torch, chip_smoke.py, chip_compare.py and
the chip_tune_*.py scripts import neither JAX nor anything of the lerc_tpu
package, at run time or in their sources."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "lerc_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_compare.py", *sorted(REPO.glob("chip_tune_*.py"))]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "lerc_tpu"


def test_import_loads_no_jax_and_no_lerc_tpu():
    code = (
        "import sys, json\n"
        "import lerc_tpu_torch\n"
        "import lerc_tpu_torch.interop, lerc_tpu_torch.kernels.build\n"
        "import lerc_tpu_torch.codec.bitmask, lerc_tpu_torch.codec.rle\n"
        "import lerc_tpu_torch.ops.device_scan, lerc_tpu_torch.ops.device_decode\n"
        "import lerc_tpu_torch.ops.device_huffman, lerc_tpu_torch.ops.huffman_scan\n"
        "import lerc_tpu_torch.codec.huffman, lerc_tpu_torch.codec.bitstuffer\n"
        "import lerc_tpu_torch.ops.device_fpl, lerc_tpu_torch.codec.fpl_impl\n"
        "import lerc_tpu_torch.parallel, lerc_tpu_torch.parallel.sharding\n"
        "import lerc_tpu_torch.api, lerc_tpu_torch.codec.orchestrator\n"
        "import lerc_tpu_torch.codec.encode_orchestrator, lerc_tpu_torch.codec.lerc1\n"
        "import lerc_tpu_torch.codec.lerc2_decode, lerc_tpu_torch.codec.lerc2_encode\n"
        "import lerc_tpu_torch.ops.probes\n"
        "from lerc_tpu_torch import compress, decompress, set_acceleration, ErrCode\n"
        "from lerc_tpu_torch import ResidentBlob, ResidentCodec\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "lerc_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_sources_import_no_jax_and_no_lerc_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert bad == []
