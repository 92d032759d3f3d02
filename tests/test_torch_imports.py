"""The port stands alone: importing it pulls in neither JAX nor the JAX
package (the card's machine has no JAX, and ``import mm_s2ut`` imports
it), nor Pillow, ``transformers`` or ``safetensors`` (the card's machine
has none of them), and no kernel is built at import time."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import mm_s2ut_torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(mm_s2ut_torch.__path__, "mm_s2ut_torch."))


STREAMING = ["mm_s2ut_torch.cli.stream", "mm_s2ut_torch.infer.streaming",
             "mm_s2ut_torch.infer.streaming_vocoder"]


TRAINING = ["mm_s2ut_torch.cli.train", "mm_s2ut_torch.tasks.s2s_task",
            "mm_s2ut_torch.train.trainer", "mm_s2ut_torch.ops.dropout"]


ENHANCED = ["mm_s2ut_torch.cli.generate", "mm_s2ut_torch.models.wav2vec2",
            "mm_s2ut_torch.models.mm_xm", "mm_s2ut_torch.tasks.s2t_task",
            "mm_s2ut_torch.data.s2t_dataset", "mm_s2ut_torch.data.sentencepiece"]


IMAGES = ["mm_s2ut_torch.models.vit", "mm_s2ut_torch.data.image_io",
          "mm_s2ut_torch.data.image_store", "mm_s2ut_torch.cli.extract_features",
          "mm_s2ut_torch.cli.vit_rollout", "mm_s2ut_torch.models.resnet_encoder"]


@pytest.mark.parametrize("modules", [["mm_s2ut_torch.inference"], STREAMING, TRAINING, MODULES,
                                     ENHANCED, IMAGES])
def test_import_leaves_jax_out(modules):
    assert set(modules) <= set(MODULES) | {"mm_s2ut_torch.inference"}
    code = (
        f"import sys, {', '.join(modules)}\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'mm_s2ut', 'transformers', 'safetensors',\n"
        "                              'PIL')]\n"
        "assert not bad, bad\n"
        "from mm_s2ut_torch.ops import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import (jax|flax|transformers|safetensors|PIL)"
                         r"|from (jax|flax|transformers|safetensors|PIL)"
                         r"|(import|from) mm_s2ut([. ]|$))", re.M)
    files = sorted((ROOT / "mm_s2ut_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
