"""The port stands alone: importing it pulls in neither JAX nor the JAX
package (the card's machine has no JAX, and ``import mm_s2ut`` imports
it), nor Pillow, ``transformers``, ``safetensors`` or ``sacrebleu`` (the
card's machine has none of them), and no kernel, nor the native audio
loader, is built at import time."""
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


EVAL_AND_PARALLEL = ["mm_s2ut_torch.eval.asr", "mm_s2ut_torch.eval.bleu",
                     "mm_s2ut_torch.eval.mcd", "mm_s2ut_torch.eval.wer",
                     "mm_s2ut_torch.eval.text_cleaner", "mm_s2ut_torch.parallel",
                     "mm_s2ut_torch.parallel.mesh"]


TOOLS = ["mm_s2ut_torch.ops.kmeans", "mm_s2ut_torch.cli.prep_data", "mm_s2ut_torch.cli.vocode",
         "mm_s2ut_torch.cli.inference_all", "mm_s2ut_torch.cli.convert_checkpoint",
         "mm_s2ut_torch.utils.torch_pickle", "mm_s2ut_torch.utils.fairseq_convert",
         "mm_s2ut_torch.utils.checkpoint", "mm_s2ut_torch.data.flac", "mm_s2ut_torch.data.ogg",
         "mm_s2ut_torch.native"]


@pytest.mark.parametrize("modules", [["mm_s2ut_torch.inference"], STREAMING, TRAINING, MODULES,
                                     ENHANCED, IMAGES, EVAL_AND_PARALLEL, TOOLS])
def test_import_leaves_jax_out(modules):
    assert set(modules) <= set(MODULES) | {"mm_s2ut_torch.inference"}
    code = (
        f"import sys, {', '.join(modules)}\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'mm_s2ut', 'transformers', 'safetensors',\n"
        "                              'PIL', 'sacrebleu')]\n"
        "assert not bad, bad\n"
        "from mm_s2ut_torch.ops import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "from mm_s2ut_torch import native\n"
        "assert native.library.cache_info().currsize == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import (jax|flax|transformers|safetensors|PIL|sacrebleu)"
                         r"|from (jax|flax|transformers|safetensors|PIL|sacrebleu)"
                         r"|(import|from) mm_s2ut([. ]|$))", re.M)
    files = sorted((ROOT / "mm_s2ut_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
