"""The port's Whisper (models/whisper.py) against the JAX package's on the
CPU, at tests/test_whisper.py's tiny sizes (vocab 320, d 32, 2 + 2 layers,
4 heads), with the weights of one random-weight transformers model built
from its config class (nothing is fetched).

Tolerances: the log-mel within 2e-4 of JAX's (the two FFTs round
differently, and a bin decades under its frame's peak moves by up to
1.5e-4 in the (log10 + 4) / 4 units; each side is as close as the other to
WhisperFeatureExtractor's numpy pipeline, within JAX's own bound of rtol
2e-4 / atol 2e-5, which the port is held to too); `encode` in f32
within 1e-5; greedy tokens equal and confidences within 1e-5, also for a
3-token forced prefix; the converted trees bitwise equal. With bf16
parameters the frameworks round at other places: the tokens of this model
still agree, and the confidences within 3e-2 (the repo's bf16 bound). The
int8 Whisper quantises the same weights bitwise, but an activation within
one f32 rounding of a .5 boundary of its int8 grid moves a whole level in
one framework: 0.3 % of the encoder's outputs (LN'd, of order 1) move, by
up to 3.5e-4, so they are held to INT8_TOL = 1e-3; the decode, fed the same
encoder output, gives equal tokens and confidences within INT8_TOL.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import whisper as jw
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import quant as jq
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import weights
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    whisper as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant as tq
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_whisper import EOS, FFN, HEADS, LAYERS, MAX_TGT, START, VOCAB, D, _hf_features

TOL = 1e-5
MEL_TOL = 2e-4
INT8_TOL = 1e-3
BF16_TOL = 3e-2
N_NEW = 12


def _cfgs():
    kw = dict(vocab_size=VOCAB, num_mel_bins=80, d_model=D, encoder_layers=LAYERS,
              encoder_attention_heads=HEADS, decoder_layers=LAYERS,
              decoder_attention_heads=HEADS, encoder_ffn_dim=FFN, decoder_ffn_dim=FFN,
              max_source_positions=1500, max_target_positions=MAX_TGT,
              decoder_start_token_id=START, eos_token_id=EOS)
    return jw.WhisperConfig(**kw), tw.WhisperConfig(**kw)


@pytest.fixture(scope="module")
def whisper():
    """(JAX cfg, JAX params, port cfg, port params, the HF state dict)."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration
    torch.manual_seed(5)
    hf = WhisperForConditionalGeneration(HFConfig(
        vocab_size=VOCAB, num_mel_bins=80, d_model=D, encoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_layers=LAYERS,
        decoder_attention_heads=HEADS, encoder_ffn_dim=FFN, decoder_ffn_dim=FFN,
        max_source_positions=1500, max_target_positions=MAX_TGT,
        decoder_start_token_id=START, eos_token_id=EOS, pad_token_id=EOS,
        bos_token_id=START)).eval()
    jcfg, tcfg = _cfgs()
    sd = hf.state_dict()
    return jcfg, jw.params_from_hf(sd, jcfg), tcfg, tw.params_from_hf(sd, tcfg), sd


@pytest.fixture(scope="module")
def feats():
    return _hf_features(_audio())                      # [2, 80, 3000]


def _audio(B=2, seconds=3.0, seed=0):
    """tests/test_whisper.py's clips (modulated tones plus noise), drawn
    from a seed of their own, so that no test's input depends on the order
    the tests run in."""
    T = int(16000 * seconds)
    t = np.arange(T) / 16000
    x = np.stack([0.3 * np.sin(2 * np.pi * (220 + 80 * b) * t)
                  * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)) for b in range(B)])
    x += 0.01 * np.random.default_rng(seed).standard_normal(x.shape)
    return x.astype(np.float32)


def _j(tree):
    return jax.tree.map(np.array, tree)


def _decode_jax(params, cfg, enc_out, prefix, n=N_NEW):
    return jax.jit(lambda p, e, pre: jw.greedy_decode(p, cfg, e, pre, max_new_tokens=n))(
        params, enc_out, prefix)


def test_log_mel_matches_jax_and_the_feature_extractor():
    x = _audio()
    xp = np.pad(x, ((0, 0), (0, 30 * 16000 - x.shape[1])))
    got = tw.log_mel_spectrogram(torch.from_numpy(xp)).numpy()
    want = np.asarray(jw.log_mel_spectrogram(jnp.asarray(xp)))
    assert got.shape == want.shape == (2, 80, 3000) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)
    np.testing.assert_allclose(got, _hf_features(x), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(tw.mel_filter_bank(201, 128), jw.mel_filter_bank(201, 128))
    np.testing.assert_array_equal(tw._sinusoids(1500, D), jw._sinusoids(1500, D))


def test_params_from_hf_matches_jax(whisper):
    """The same numbers as JAX's conversion, the conv kernels in torch's
    layout, as f32 CPU tensors; the bridge from JAX's tree gives the same."""
    jcfg, jparams, tcfg, tparams, _ = whisper
    want = dict(leaves_with_paths(_j(jparams)))
    got = dict(leaves_with_paths(tparams))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu", path
        w = want[path].transpose(2, 1, 0) if path.endswith(("conv1/kernel", "conv2/kernel")) \
            else want[path]
        np.testing.assert_array_equal(leaf.numpy(), w, err_msg=path)
    bridged = weights.whisper_params_from_jax(_j(jparams), tcfg, device="cpu")
    for path, leaf in leaves_with_paths(bridged):
        np.testing.assert_array_equal(leaf.numpy(), got[path].numpy(), err_msg=path)


def test_whisper_params_from_jax_is_strict():
    jcfg, tcfg = _cfgs()
    tree = _j(jw.init_whisper(jax.random.key(0), jcfg))
    port = weights.whisper_params_from_jax(tree, tcfg, device="cpu")
    assert tuple(port["encoder"]["conv1"]["kernel"].shape) == (D, 80, 3)
    np.testing.assert_array_equal(port["encoder"]["conv2"]["kernel"].numpy(),
                                  tree["encoder"]["conv2"]["kernel"].transpose(2, 1, 0))
    tree["decoder"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="decoder/extra"):
        weights.whisper_params_from_jax(tree, tcfg, device="cpu")
    del tree["decoder"]["extra"], tree["decoder"]["pos"]
    with pytest.raises(KeyError, match="decoder/pos"):
        weights.whisper_params_from_jax(tree, tcfg, device="cpu")


def test_init_whisper_shapes_and_dtypes():
    jcfg, tcfg = _cfgs()
    want = dict(leaves_with_paths(_j(jw.init_whisper(jax.random.key(0), jcfg))))
    got = tw.init_whisper(tcfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    for path, leaf in leaves_with_paths(got):
        shape = want[path].shape[::-1] if path.endswith(("conv1/kernel", "conv2/kernel")) \
            else want[path].shape
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.bfloat16, path
    assert set(dict(leaves_with_paths(got))) == set(want)


def test_encode_matches_jax(whisper, feats):
    jcfg, jparams, tcfg, tparams, _ = whisper
    want = np.asarray(jw.encode(jparams, jcfg, jnp.asarray(feats)))
    got = tw.encode(tparams, tcfg, torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, 1500, D)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prefix", [[START], [START, 5, 9]], ids=["1-token", "3-token"])
def test_greedy_decode_matches_jax(whisper, feats, prefix):
    jcfg, jparams, tcfg, tparams, _ = whisper
    pre = np.asarray([prefix, prefix], np.int32)
    enc = jw.encode(jparams, jcfg, jnp.asarray(feats))
    want_t, want_c = (np.asarray(a) for a in _decode_jax(jparams, jcfg, enc, jnp.asarray(pre)))
    got_t, got_c = tw.greedy_decode(tparams, tcfg, torch.from_numpy(np.array(enc)),
                                    torch.from_numpy(pre), max_new_tokens=N_NEW)
    assert got_t.dtype == torch.int32 and tuple(got_t.shape) == (2, N_NEW)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=TOL, atol=TOL)


def test_a_row_freezes_at_eos():
    """Rows that emit EOS (here row 1 at its first step, row 0 later, with
    EOS's embedding scaled up) repeat it with confidence 1 from then on,
    as JAX's do."""
    jcfg, tcfg = _cfgs()
    tree = _j(jw.init_whisper(jax.random.key(1), jcfg))
    tree["decoder"]["embed_tokens"][EOS] *= 300.0
    port = weights.whisper_params_from_jax(tree, tcfg, device="cpu")
    enc = np.random.default_rng(0).standard_normal((2, 10, D)).astype(np.float32)
    pre = np.full((2, 1), START, np.int32)
    want_t, want_c = (np.asarray(a) for a in _decode_jax(tree, jcfg, jnp.asarray(enc),
                                                          jnp.asarray(pre), n=6))
    got_t, got_c = tw.greedy_decode(port, tcfg, torch.from_numpy(enc), torch.from_numpy(pre),
                                    max_new_tokens=6)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=TOL, atol=TOL)
    first = [list(row).index(EOS) for row in want_t]
    assert first[1] == 0 and 0 < first[0] < 5
    for row, k in enumerate(first):
        assert (got_t[row, k:] == EOS).all() and (got_c[row, k + 1:] == 1.0).all()


def test_transcribe_batch_bf16_params(whisper):
    """The serving dtype: bf16 parameters (the f32 log-mel cast to them in
    encode) decode as JAX's do."""
    jcfg, jparams, tcfg, tparams, _ = whisper
    x = _audio(B=2, seconds=2.0)
    pre = np.full((2, 1), START, np.int32)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    want_t, want_c = (np.asarray(a, np.float32) for a in jw.transcribe_batch(
        jb, jcfg, jnp.asarray(x), jnp.asarray(pre), max_new_tokens=8))
    got_t, got_c = tw.transcribe_batch(_bf16(tparams), tcfg, torch.from_numpy(x), torch.from_numpy(pre),
                                       max_new_tokens=8)
    assert got_c.dtype == torch.float32 and torch.isfinite(got_c).all()
    assert ((got_c > 0) & (got_c <= 1)).all()
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=BF16_TOL, atol=BF16_TOL)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def test_int8_whisper_matches_jax(whisper, feats):
    """quantize_whisper on both sides (min_size 16 at these widths): encode
    and the greedy decode through the int8 linears."""
    jcfg, jparams, tcfg, tparams, _ = whisper
    jq_params = jq.quantize_whisper(jparams, min_size=16)
    tq_params = tq.quantize_whisper(tparams, min_size=16)
    assert "kernel_q" in tq_params["decoder"]["layers"]["self_attn"]["q"]
    enc = jw.encode(jq_params, jcfg, jnp.asarray(feats))
    got_enc = tw.encode(tq_params, tcfg, torch.from_numpy(feats))
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), rtol=0, atol=INT8_TOL)
    pre = np.full((2, 1), START, np.int32)
    want_t, want_c = (np.asarray(a) for a in _decode_jax(jq_params, jcfg, enc, jnp.asarray(pre)))
    got_t, got_c = tw.greedy_decode(tq_params, tcfg, torch.from_numpy(np.array(enc)),
                                    torch.from_numpy(pre), max_new_tokens=N_NEW)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=INT8_TOL)
