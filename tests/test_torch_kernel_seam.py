"""The seam every hand-written kernel of the port shares, on the CPU.

One no-backward rule (ops/_build.takes_plain): a wrapper whose call wants a
gradient runs its plain version on the CPU, keeping the history, and a call
on a device other than the CPU and CUDA raises. One launch table
(utils/profiling): each kernel's module puts its key there at 0 when it is
imported, and the profiling module imports no kernel. One build recipe
(ops/_build.library_path): a library's name hashes its source and its flags,
and a source links libcuda where it encodes TMA tensor maps.
"""

import ast
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    classifier as tclf, layers as tl)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    _build, conv_front as cf, conv_tail as ct, pos_conv as pc, residual_stack as rs)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import tree_to

from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
PORT = "multilingual_multimodal_speech_emotion_recognition_tpu_torch"


def _front_args(g):
    C, T = 8, 120
    conv0 = {"kernel": torch.randn(C, 1, 10, generator=g),
             "bias": 0.1 * torch.randn(C, generator=g)}
    group_norm = {"scale": 1 + 0.1 * torch.randn(C, generator=g),
                  "bias": 0.1 * torch.randn(C, generator=g)}
    return [conv0, group_norm, torch.randn(2, T, generator=g), torch.tensor([T, 70]), 5]


def _tail_args(g):
    C = 8
    convs = [{"kernel": 0.3 * torch.randn(C, C if i else 1, k, generator=g),
              "bias": 0.1 * torch.randn(C, generator=g)}
             for i, k in enumerate((10, *ct.TAIL_KERNELS))]
    return [convs, torch.randn(2, 100, C, generator=g)]


def _stack_args(g):
    stacked = tclf.init_classifier(tl.Init(g, "cpu"), 8, 4, 2, 16)["layers"]
    return [stacked, torch.randn(3, 16, generator=g)]


def _pos_args(g):
    Cg, G, K = 4, 2, 6
    conv = {"kernel": 0.3 * torch.randn(Cg * G, Cg, K, generator=g),
            "bias": 0.1 * torch.randn(Cg * G, generator=g)}
    return [conv, torch.randn(2, 11, Cg * G, generator=g)]


# name: (wrapper, its plain version, its arguments, the leaf given a gradient)
GUARDED = {
    "conv_front": (cf.conv_front, cf.conv_front_plain, _front_args, lambda a: a[0]["kernel"]),
    "conv_tail": (functools.partial(ct.conv_tail, has_ln=False),
                  functools.partial(ct.conv_tail_plain, has_ln=False), _tail_args,
                  lambda a: a[0][3]["kernel"]),
    "residual_stack": (rs.residual_stack, rs.residual_stack_plain, _stack_args,
                       lambda a: a[0]["block_lin1"]["kernel"]),
    "pos_conv": (pc.pos_conv, pc.pos_conv_plain, _pos_args, lambda a: a[0]["kernel"]),
}
LAUNCH_KEYS = ("residual_stack.launches", "attentive_stats_pooling.launches",
               "flash_attention.launches", "conv_front.launches", "conv_tail.launches",
               "pos_conv.launches", "int8_matmul.launches")


def _launch_table() -> dict:
    return {k: v for k, v in profiling.counters().items() if k.endswith(".launches")}


@pytest.mark.parametrize("name", list(GUARDED))
def test_wrapper_keeps_the_history_on_cpu_and_has_no_kernel_for_meta(name):
    """With a gradient wanted on the CPU the wrapper returns its plain
    version with its history, and the gradient reaches the leaf; on `meta`
    it raises its own message. Neither counts a launch."""
    wrapper, plain, make_args, leaf = GUARDED[name]
    args = make_args(torch.Generator().manual_seed(0))
    before = _launch_table()
    leaf(args).requires_grad_()
    got = wrapper(*args)
    assert got.grad_fn is not None
    assert torch.equal(got, plain(*args))
    got.square().sum().backward()
    assert leaf(args).grad is not None and leaf(args).grad.abs().sum() > 0
    meta = [a if isinstance(a, int) else tree_to(a, "meta") for a in args]
    with pytest.raises(ValueError) as err:
        wrapper(*meta)
    assert str(err.value) == f"{name}: no kernel for device meta"
    assert _launch_table() == before


def test_launch_table_starts_at_zero_and_profiling_imports_no_kernel():
    """In a fresh process the seven kernels' modules put their keys in the
    table at 0, and a launch site's `launched` adds one under its own key;
    utils/profiling.py's imports name no `ops` module."""
    code = (f"import json\nfrom {PORT}.ops import (attentive_pooling, conv_front, conv_tail,"
            " flash_attention, pos_conv, quant, residual_stack)\n"
            f"from {PORT}.utils import profiling\nprint(json.dumps(profiling.counters()))\n"
            "profiling.launched(pos_conv.LAUNCHES)\nprint(json.dumps(profiling.counters()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    fresh, after = (json.loads(line) for line in out.splitlines()[-2:])
    assert fresh == dict.fromkeys(LAUNCH_KEYS, 0)
    assert after == {**fresh, "pos_conv.launches": 1}
    tree = ast.parse(Path(profiling.__file__).read_text())
    modules = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    modules += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert not [m for m in modules if "ops" in m.split(".")]


# the sources that encode TMA tensor maps (cuTensorMapEncodeTiled) and link libcuda
LIBCUDA = ("attentive_pooling", "conv_tail", "pos_conv", "residual_stack")


@pytest.mark.parametrize("name", ["attentive_pooling", "conv_front", "conv_tail",
                                  "flash_attention", "pos_conv", "residual_stack"])
def test_library_path_hashes_the_source_and_its_flags(name):
    """The library's name hashes the source and nvcc's flags, `-lcuda`
    among them exactly for the TMA sources: an unchanged source keeps its
    library."""
    src = _build.CSRC / f"{name}.cu"
    flags = _build.NVCC_FLAGS + (("-lcuda",) if name in LIBCUDA else ())
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    assert _build.link_flags(name) == flags[len(_build.NVCC_FLAGS):]
    assert _build.library_path(name) == _build.BUILD_DIR / f"lib{name}-{digest}.so"
