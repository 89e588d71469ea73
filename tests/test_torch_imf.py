"""The port's IMF serving path (smalltts_tpu_torch/train/imf.py, the "imf"
and gated "dmd" samplers of infer/sampler.py and SmallTTS's sampler
policy) against the JAX package on the CPU, on an IMF checkpoint: the tiny
backbone with its adaLN modulations and velocity head redrawn (at zero
every block is the identity and the gate could not matter) and an r_gate
drawn from N(0, 0.1).

Tolerances: fp32 latents and waveforms 1e-5 relative to the largest value
(fp32 sums in another order); int16 waveforms within 1 LSB; the bf16 time
embedding bit for bit under jax.jit; bf16 waveforms 2e-2 rel-L2 (5.1e-3
IMF-2 and 6.4e-3 gated DMD-4 measured at this configuration: the bf16
products' fp32 sums run in another order in XLA and in PyTorch, and a
flipped rounding carries through the steps and the codec).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS  # noqa: E402
from smalltts_tpu.models.backbone import encode_conditions as j_encode_conditions  # noqa: E402
from smalltts_tpu.models.backbone import init_backbone as j_init_backbone  # noqa: E402
from smalltts_tpu.models.codec import init_codec as j_init_codec  # noqa: E402
from smalltts_tpu.ops.masking import length_mask as j_length_mask  # noqa: E402
from smalltts_tpu.train import imf as JI  # noqa: E402
from smalltts_tpu_torch.data.bucketing import HOP_SIZE  # noqa: E402
from smalltts_tpu_torch.infer.pipeline import SmallTTS, _cast_tree  # noqa: E402
from smalltts_tpu_torch.infer.sampler import draw_noises, noise_draws, sample_latents  # noqa: E402
from smalltts_tpu_torch.models.backbone import encode_conditions  # noqa: E402
from smalltts_tpu_torch.models.dit import fuse_serving_projections, quantize_modulations  # noqa: E402
from smalltts_tpu_torch.models.dit import quantize_stream_weights  # noqa: E402
from smalltts_tpu_torch.ops.masking import length_mask  # noqa: E402
from smalltts_tpu_torch.train import imf as PI  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
B, R, P, TB = 2, 64, 128, 16
BF16_REL_L2 = 2e-2


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def imf_checkpoint(seed=0):
    """A JAX IMF student whose modulations, velocity head and r_gate matter."""
    rs = np.random.RandomState(seed)
    jp = JI.init_imf_student(j_init_backbone(jax.random.PRNGKey(seed), TINY_BACKBONE))
    dit = jp["dit"]
    for lin in (dit["blocks"]["attn_norm"]["linear"], dit["norm_out"]["linear"], jp["velocity"]):
        for k in lin:
            lin[k] = jnp.asarray((0.2 if k == "w" else 0.5) * rs.randn(*lin[k].shape), jnp.float32)
    jp["r_gate"] = jnp.asarray(0.1 * rs.randn(*jp["r_gate"].shape), jnp.float32)
    return jp


@pytest.fixture(scope="module")
def weights():
    jp = imf_checkpoint()
    jc = j_init_codec(jax.random.PRNGKey(1), TINY_CODEC)
    return jp, jc, params_from_jax(to_np(jp), PCFG), params_from_jax(to_np(jc), PCODEC)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(2)
    return (rs.randn(B, R, 64).astype(np.float32), np.array([40, 9], np.int32),
            rs.randint(1, 198, size=(B, P)).astype(np.int32), np.array([100, 31], np.int32),
            np.array([TB, 11], np.int32))


def test_init_imf_student_copies_the_teacher(weights):
    _, _, tp, _ = weights
    teacher = {k: v for k, v in tp.items() if k != "r_gate"}
    student = PI.init_imf_student(teacher)
    assert student["r_gate"].dtype == torch.float32 and student["r_gate"].shape == (PCFG.hidden_dim,)
    assert not student["r_gate"].any()
    w, sw = teacher["dit"]["blocks"]["ff"]["w2"]["w"], student["dit"]["blocks"]["ff"]["w2"]["w"]
    assert torch.equal(w, sw) and w.data_ptr() != sw.data_ptr()
    jstudent = JI.init_imf_student(j_init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE))
    assert jstudent["r_gate"].dtype == jnp.float32 and tuple(jstudent["r_gate"].shape) == tuple(student["r_gate"].shape)


def _time_emb_tree(width, seed=3):
    """The leaves imf_time_emb reads, at the model's width: the time MLP
    (256 -> width -> width) and r_gate, drawn from a seed."""
    rs = np.random.RandomState(seed)
    lin = lambda i, o: {"w": jnp.asarray(rs.randn(i, o) / np.sqrt(i), jnp.float32),  # noqa: E731
                        "b": jnp.asarray(0.1 * rs.randn(o), jnp.float32)}
    return {"time_embedding": {"l1": lin(256, width), "l2": lin(width, width)},
            "r_gate": jnp.asarray(0.1 * rs.randn(width), jnp.float32)}


@pytest.mark.parametrize("width", ["tiny", "960"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_imf_time_emb_equals_jax(weights, dtype, width):
    """te(t) + r_gate * te(r) for the served intervals of IMF-1, -2 and -4,
    on the tiny checkpoint and at the model's width (960): 1e-5 relative
    in fp32, bit for bit in bf16 against jax.jit."""
    jp, _, tp, _ = weights
    if width == "960":
        jp = _time_emb_tree(960)
        tp = params_from_jax(to_np(jp), None)  # not a whole backbone: no block stacks to check
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jax.tree.map(lambda x: x.astype(jd), jp)
    tq = _cast_tree(tp, td, "cpu")
    ts = np.concatenate([np.linspace(1, 0, n + 1, dtype=np.float32) for n in (1, 2, 4)])
    t, r = ts[:-1], ts[1:]
    want = np.asarray(jax.jit(lambda p, t, r: JI.imf_time_emb(p, TINY_BACKBONE, t, r))(jq, t, r).astype(jnp.float32))
    got = PI.imf_time_emb(tq, PCFG, torch.from_numpy(t), torch.from_numpy(r))
    assert got.dtype == td
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert rel_err(got, want) < 1e-5
    gate = np.asarray(jq["r_gate"].astype(jnp.float32))
    assert np.abs(gate).max() > 0.1  # the gate term is in the sum


def _conditions(jp, tp, batch):
    ref, ref_len, ph, ph_len, seq = batch
    jcond = j_encode_conditions(jp, TINY_BACKBONE, jnp.asarray(ref), jnp.asarray(ref_len), jnp.asarray(ph),
                                j_length_mask(jnp.asarray(ph_len), P))
    T = torch.from_numpy
    pcond = encode_conditions(tp, PCFG, T(ref), T(ref_len), T(ph).long(), length_mask(T(ph_len), P))
    return jcond, pcond


def test_imf_velocity_equals_jax(weights, batch):
    jp, _, tp, _ = weights
    jcond, pcond = _conditions(jp, tp, batch)
    seq = batch[4]
    x = np.random.RandomState(4).randn(B, TB, 64).astype(np.float32)
    t, r = np.array([1.0, 0.7], np.float32), np.array([0.5, 0.2], np.float32)
    want = JI.imf_velocity(jp, TINY_BACKBONE, jnp.asarray(x), j_length_mask(jnp.asarray(seq), TB), jnp.asarray(t),
                           jnp.asarray(r), jcond)
    T = torch.from_numpy
    got = PI.imf_velocity(fuse_serving_projections(tp), PCFG, T(x), length_mask(T(seq), TB), T(t), T(r), pcond)
    assert rel_err(got.numpy(), want) < 1e-5 and float(np.abs(np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("steps", [1, 2])
def test_imf_sample_equals_jax(weights, batch, steps):
    """imf_sample from the start noise the JAX function draws from its key."""
    jp, _, tp, _ = weights
    jcond, pcond = _conditions(jp, tp, batch)
    seq = batch[4]
    key = jax.random.PRNGKey(11)
    want = JI.imf_sample(jp, TINY_BACKBONE, jcond, jnp.asarray(seq), TB, key, steps)
    noise = np.asarray(jax.random.normal(key, (B, TB, 64), jnp.float32))
    got = PI.imf_sample(fuse_serving_projections(tp), PCFG, pcond, torch.from_numpy(seq), TB,
                        torch.from_numpy(noise), steps)
    assert rel_err(got.numpy(), want) < 1e-5
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert not np.asarray(want)[1, 11:].any() and not got[1, 11:].any()  # masked past the length


def test_imf_noise_is_one_start_draw(weights, batch):
    _, _, tp, _ = weights
    assert noise_draws("imf", 2) == 1 and noise_draws("dmd", 4) == 4
    with pytest.raises(ValueError, match="sampler must be"):
        noise_draws("euler", 4)
    g = torch.Generator().manual_seed(0)
    assert draw_noises(2, B, TB, 64, torch.float32, "cpu", g, "imf").shape == (1, B, TB, 64)
    assert draw_noises(4, B, TB, 64, torch.float32, "cpu", g).shape == (4, B, TB, 64)
    T = torch.from_numpy
    args = (fuse_serving_projections(tp), PCFG, T(batch[0]), T(batch[1]), T(batch[2]).long(), T(batch[3]),
            T(batch[4]))
    with pytest.raises(ValueError, match="steps"):
        sample_latents(*args, num_steps=2, noises=torch.zeros(2, B, TB, 64), sampler="imf")
    lat = sample_latents(*args, num_steps=2, noises=torch.zeros(1, B, TB, 64), sampler="imf")
    assert lat.shape == (B, TB, 64)


def test_the_gate_matters_in_the_dmd_recurrence(weights, batch):
    """The gated DMD loop evaluates u(x, t, t) with the (1 + r_gate)
    embedding: dropping r_gate changes the latents."""
    _, _, tp, _ = weights
    T = torch.from_numpy
    noises = T(np.random.RandomState(5).randn(4, B, TB, 64).astype(np.float32))
    args = (PCFG, T(batch[0]), T(batch[1]), T(batch[2]).long(), T(batch[3]), T(batch[4]))
    gated = sample_latents(fuse_serving_projections(tp), *args, noises=noises)
    plain = sample_latents(fuse_serving_projections({k: v for k, v in tp.items() if k != "r_gate"}), *args,
                           noises=noises)
    assert rel_err(gated.numpy(), plain.numpy()) > 1e-3


POLICY = {  # name -> (r_gate checkpoint, sampler, num_steps, expected (sampler, steps))
    "auto_imf_checkpoint": (True, "auto", None, ("imf", 2)),
    "auto_plain_checkpoint": (False, "auto", None, ("dmd", 4)),
    "explicit_imf": (True, "imf", None, ("imf", 2)),
    "explicit_dmd_on_imf_checkpoint": (True, "dmd", None, ("dmd", 4)),
    "imf_explicit_steps": (True, "imf", 1, ("imf", 1)),
    "auto_imf_explicit_4": (True, "auto", 4, ("imf", 4)),
    "dmd_explicit_2": (False, "dmd", 2, ("dmd", 2)),
}


@pytest.mark.parametrize("case", list(POLICY))
def test_sampler_policy_equals_jax(weights, case):
    """The JAX policy (tests/test_imf.py:148): auto serves an r_gate
    checkpoint with IMF-2 and a plain one with DMD-4; an explicit
    num_steps always wins."""
    jp, jc, tp, tc = weights
    gated, sampler, steps, want = POLICY[case]
    if not gated:
        jp = {k: v for k, v in jp.items() if k != "r_gate"}
        tp = {k: v for k, v in tp.items() if k != "r_gate"}
    j = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", sampler=sampler, num_steps=steps)
    t = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", sampler=sampler, num_steps=steps)
    assert (t.sampler, t.num_steps) == (j.sampler, j.num_steps) == want
    assert ("r_gate" in t.params) == gated


def test_imf_without_r_gate_and_unknown_samplers_raise(weights, batch):
    """sampler="imf" on a plain checkpoint raises in both packages (the
    port at construction, the JAX package when the graph first traces), and
    an unknown sampler raises ValueError in both."""
    jp, jc, tp, tc = weights
    jplain = {k: v for k, v in jp.items() if k != "r_gate"}
    tplain = {k: v for k, v in tp.items() if k != "r_gate"}
    with pytest.raises(ValueError, match="r_gate"):
        SmallTTS(tplain, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", sampler="imf")
    j = JSmallTTS(jplain, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", sampler="imf")
    with pytest.raises(KeyError, match="r_gate"):
        j.synthesize_padded(*batch, TB)
    for make in (lambda: SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", sampler="euler"),
                 lambda: JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", sampler="euler")):
        with pytest.raises(ValueError, match="sampler must be"):
            make()


def _jax_noises(sampler, key, dtype, steps):
    """The noise the JAX pipeline draws from `key`: imf_sample's one start
    draw, or _sample_loop's split per step."""
    if sampler == "imf":
        return np.asarray(jax.random.normal(key, (B, TB, 64), dtype).astype(jnp.float32))[None]
    out, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(sub, (B, TB, 64), dtype).astype(jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("pcm16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampler", ["imf", "dmd"])
def test_synthesize_padded_equals_jax_pipeline(weights, batch, sampler, dtype, pcm16):
    """The whole pipeline on the IMF checkpoint: IMF-2 ("auto") and the
    gated DMD-4 ("dmd"), against JAX's synthesize_padded with the noise its
    key draws."""
    jp, jc, tp, tc = weights
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", dtype=jd,
                  sampler="auto" if sampler == "imf" else sampler, pcm16_out=pcm16)
    t = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", dtype=td,
                 sampler="auto" if sampler == "imf" else sampler, pcm16_out=pcm16)
    assert t.sampler == j.sampler == sampler and t.num_steps == j.num_steps
    key = jax.random.PRNGKey(7)
    want = j.synthesize_padded(*batch, TB, key=key)
    got = t.synthesize_padded(*batch, TB, noises=_jax_noises(sampler, key, jd, t.num_steps))
    assert got.shape == want.shape == (B, 1, TB * HOP_SIZE) and got.dtype == want.dtype
    assert np.abs(want).max() > (100 if pcm16 else 3e-3)
    if dtype == "bfloat16":
        assert rel_l2(got, want) < BF16_REL_L2
    elif pcm16:
        assert int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) <= 1
    else:
        assert rel_err(got, want) < 1e-5


def test_int8_modulation_imf_equals_jax(weights, batch):
    """IMF-2 with int8 modulation weights (w8_modulation) in both packages:
    int16 within 1 LSB."""
    jp, jc, tp, tc = weights
    j = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", w8_modulation=True, pcm16_out=True)
    t = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", w8_modulation=True, pcm16_out=True)
    assert t.sampler == "imf" and "w_q" in t.params["dit"]["blocks"]["attn_norm"]["linear"]
    key = jax.random.PRNGKey(8)
    want = j.synthesize_padded(*batch, TB, key=key)
    got = t.synthesize_padded(*batch, TB, noises=_jax_noises("imf", key, jnp.float32, 2))
    assert int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) <= 1 and np.abs(want).max() > 100


def test_r_gate_survives_every_transform(weights, tmp_path):
    """r_gate is kept, with its values, by params_from_jax, the dtype cast,
    the projection fusion, both int8 quantizers and an npz checkpoint of
    the JAX package (which then serves through IMF-2)."""
    from smalltts_tpu.utils import checkpoint as jckpt
    from smalltts_tpu.utils.config_io import backbone_meta

    jp, _, tp, _ = weights
    want = np.asarray(jp["r_gate"])
    np.testing.assert_array_equal(tp["r_gate"].numpy(), want)
    tree = _cast_tree(tp, torch.bfloat16, "cpu")
    for fn in (fuse_serving_projections, quantize_modulations, quantize_stream_weights):
        tree = fn(tree)
        assert tree["r_gate"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tree["r_gate"].float().numpy(),
                                      np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32)))
    path = str(tmp_path / "imf.npz")
    jckpt.save_pytree(path, jp, meta=backbone_meta(TINY_BACKBONE))
    t = SmallTTS(checkpoint=path, device="cpu", codec_cfg=PCODEC)
    assert t.sampler == "imf" and t.num_steps == 2
    np.testing.assert_array_equal(t.params["r_gate"].numpy(), want)
