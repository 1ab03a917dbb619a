"""The port never imports JAX or the JAX package: in a fresh interpreter
where `import jax` fails, every module of the port and chip_smoke.py
import, and no module of the JAX package is loaded."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK = """
import importlib, json, pkgutil, sys
for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    sys.modules[name] = None
sys.modules["jax"] = None
import multilingual_multimodal_speech_emotion_recognition_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
jax_package = "multilingual_multimodal_speech_emotion_recognition_tpu"
loaded = sorted(m for m in sys.modules if m == jax_package or m.startswith(jax_package + "."))
print(json.dumps({"imported": names, "jax_package": loaded}))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax_package"] == []
    port = "multilingual_multimodal_speech_emotion_recognition_tpu_torch."
    for module in ("ops.conv_tail", "ops.flash_attention", "ops.attentive_pooling",
                   "ops.residual_stack", "models.model", "weights",
                   "ops.audio_dsp", "ops.openmax", "data.manifest", "data.audio_io",
                   "data.native", "data.tokenizer", "data.bucketing", "data.pipeline",
                   "data.prefetch", "utils.metrics", "eval.evaluate", "train.checkpoint",
                   "cli.eval", "models.remat", "models.prototypes", "ops.losses",
                   "train.optimizer", "train.train_step", "train.loop", "cli.train",
                   "export", "serving", "interface", "integration", "research.temporal",
                   "research.dual_gate_ood", "cli.export", "cli.serve", "cli.infer",
                   "models.hf_convert", "models.ref_convert", "cli.import_checkpoint",
                   "cli.export_torch", "cli.make_manifest", "ops.quant", "models.whisper",
                   "frontend.asr"):
        assert port + module in report["imported"]
