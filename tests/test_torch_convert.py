"""Reference torch checkpoints in the port: smalltts_tpu_torch/utils/torch_convert.py
against the JAX package's converters, the .pt/.pth/.bin loader, and the
entry points that take such a file (SmallTTS, train_teacher and its command
line).

The state dicts carry the reference's key names. The backbone's is built
from seeded tiny JAX params by `reference_state_dict`, an inverse written
here and checked by the JAX converter (`convert_backbone_state_dict` of it
gives the params back, bit for bit); the ASR, discriminator and SV ones come
from the structural replicas of tests/test_torch_convert_aux.py.

Tolerances: the converters are held bit for bit (they only transpose,
concatenate and stack); latents through the pipeline at 1e-5 relative to
the largest value, as tests/test_torch_pipeline.py holds an npz checkpoint.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from test_torch_convert_aux import (  # noqa: E402
    ASRReplica, DiscriminatorReplica, _fake_speechbrain_ecapa_sd, _randomize_bn_stats)
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS  # noqa: E402
from smalltts_tpu.infer.sampler import sample_latents as j_sample_latents  # noqa: E402
from smalltts_tpu.models.backbone import init_backbone as j_init_backbone  # noqa: E402
from smalltts_tpu.models.sv import SVConfig  # noqa: E402
from smalltts_tpu.train import teacher as JT  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import torch_convert as J  # noqa: E402
from smalltts_tpu_torch.infer.pipeline import SmallTTS  # noqa: E402
from smalltts_tpu_torch.infer.sampler import sample_latents  # noqa: E402
from smalltts_tpu_torch.train import teacher as PT  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils import torch_convert as P  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL = 1e-5
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))


# ------------------------------------------------------------------ the inverse


def _lin(sd, key, p, bias=True):
    sd[f"{key}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
    if bias:
        sd[f"{key}.bias"] = np.asarray(p["b"])


def _split_lins(sd, keys, p):
    """A fused (in, n * out) weight and its bias -> n reference Linears."""
    ws = np.split(np.asarray(p["w"]), len(keys), axis=1)
    bs = np.split(np.asarray(p["b"]), len(keys))
    for k, w, b in zip(keys, ws, bs):
        sd[f"{k}.weight"] = np.ascontiguousarray(w.T)
        sd[f"{k}.bias"] = b


def _conv(sd, key, p):
    sd[f"{key}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).transpose(2, 1, 0))
    sd[f"{key}.bias"] = np.asarray(p["b"])


def _block(tree, i):
    return jax.tree.map(lambda x: np.asarray(x)[i], tree)


def _encoder(sd, pre, p):
    for i in range(np.asarray(jax.tree.leaves(p["blocks"])[0]).shape[0]):
        b, k = _block(p["blocks"], i), f"{pre}.blocks.{i}"
        for name in ("wq", "wk", "wv", "wo", "gate"):
            _lin(sd, f"{k}.attention.{name}", b["attn"][name], bias=False)
        sd[f"{k}.attention.q_norm.weight"] = b["attn"]["q_norm"]["scale"]
        sd[f"{k}.attention.k_norm.weight"] = b["attn"]["k_norm"]["scale"]
        for name in ("w1", "w3", "w2"):
            _lin(sd, f"{k}.mlp.{name}", b["mlp"][name], bias=False)
        sd[f"{k}.attention_norm.weight"] = b["attention_norm"]["scale"]
        sd[f"{k}.mlp_norm.weight"] = b["mlp_norm"]["scale"]
    sd[f"{pre}.norm.weight"] = np.asarray(p["norm"]["scale"])


def reference_state_dict(params):
    """JAX backbone params -> the reference DiTModel's state_dict (numpy),
    the inverse of smalltts_tpu/utils/torch_convert.convert_backbone_state_dict."""
    sd = {}
    _lin(sd, "time_embedding.mlp.0", params["time_embedding"]["l1"])
    _lin(sd, "time_embedding.mlp.2", params["time_embedding"]["l2"])
    text = params["phoneme_embedding"]
    sd["phoneme_embedding.text_embedding.weight"] = np.asarray(text["text_embedding"]["w"])
    _encoder(sd, "phoneme_embedding", text)
    style = params["style_encoder"]
    _lin(sd, "style_encoder.in_proj", style["in_proj"])
    sd["style_encoder.log_scale"] = np.asarray(style["log_scale"])
    _encoder(sd, "style_encoder", style)
    _lin(sd, "style_encoder.out_proj", style["out_proj"])
    dit = params["dit"]
    _lin(sd, "dit.input_embed.proj", dit["input_embed"]["proj"])
    _conv(sd, "dit.input_embed.conv_pos_embed.conv1", dit["input_embed"]["conv1"])
    _conv(sd, "dit.input_embed.conv_pos_embed.conv2", dit["input_embed"]["conv2"])
    _lin(sd, "dit.phoneme_proj", dit["phoneme_proj"])
    _lin(sd, "dit.emb_proj.0", dit["emb_proj"]["l1"])
    _lin(sd, "dit.emb_proj.2", dit["emb_proj"]["l2"])
    for i in range(np.asarray(jax.tree.leaves(dit["blocks"])[0]).shape[0]):
        b, k = _block(dit["blocks"], i), f"dit.transformer_blocks.{i}"
        _lin(sd, f"{k}.attn_norm.linear", b["attn_norm"]["linear"])
        a = b["attn"]
        _split_lins(sd, [f"{k}.attn.to_q", f"{k}.attn.to_k_self", f"{k}.attn.to_v_self"], a["qkv_self"])
        _lin(sd, f"{k}.attn.gate", a["gate"], bias=False)
        _lin(sd, f"{k}.attn.to_out.0", a["to_out"], bias=False)
        sd[f"{k}.attn.q_norm.weight"] = a["q_norm"]["scale"]
        sd[f"{k}.attn.k_norm.weight"] = a["k_norm"]["scale"]
        _split_lins(sd, [f"{k}.attn.to_k_ref", f"{k}.attn.to_v_ref"], a["kv_ref"])
        _split_lins(sd, [f"{k}.attn.to_k_text", f"{k}.attn.to_v_text"], a["kv_text"])
        sd[f"{k}.attn.k_norm_cross.weight"] = a["k_norm_cross"]["scale"]
        for name in ("w1", "w3", "w2"):
            _lin(sd, f"{k}.ff.{name}", b["ff"][name])
    _lin(sd, "dit.norm_out.linear", dit["norm_out"]["linear"])
    _lin(sd, "velocity", params["velocity"])
    return sd


def redraw(params, seed=0):
    """The zero-init adaLN, final and velocity leaves redrawn, so the
    latents depend on every block (as tests/test_torch_pipeline.py does)."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)
    dit = params["dit"]
    for lin in (dit["blocks"]["attn_norm"]["linear"], dit["norm_out"]["linear"], params["velocity"]):
        for k in lin:
            lin[k] = ((0.2 if k == "w" else 0.5) * rs.randn(*lin[k].shape)).astype(np.float32)
    return params


def assert_trees_equal(got, want, path=""):
    """Same keys, nesting, shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}#{i}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), path


@pytest.fixture(scope="module")
def jparams():
    return redraw(j_init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE))


@pytest.fixture(scope="module")
def ref_sd(jparams):
    return reference_state_dict(jparams)


def _to_torch(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


# ------------------------------------------------------------------ converters


def test_inverse_is_exact(jparams, ref_sd):
    assert_trees_equal(J.convert_backbone_state_dict(ref_sd), jparams)


def test_port_inverse_gives_the_reference_state_dict(jparams, ref_sd):
    """The port's backbone_state_dict (which chip_smoke.py saves as a .pt)
    gives this test's inverse, from numpy leaves and from the port's own
    params (params_to_jax of params_from_jax), on which JAX's converter
    gives the params back."""
    from smalltts_tpu_torch.utils.convert import params_to_jax

    for tree in (jparams, params_to_jax(params_from_jax(jparams, PCFG))):
        sd = P.backbone_state_dict(tree)
        assert sd.keys() == ref_sd.keys()
        assert all(v.dtype == torch.float32 and v.is_contiguous() and np.array_equal(v.numpy(), ref_sd[k])
                   for k, v in sd.items())
    assert_trees_equal(J.convert_backbone_state_dict(J.state_dict_to_numpy(sd)), jparams)


@pytest.mark.parametrize("part", ["backbone", "text", "style", "dit"])
def test_backbone_converters_match_jax(ref_sd, part):
    sd = J.state_dict_to_numpy(_to_torch(ref_sd))
    assert_trees_equal(P.state_dict_to_numpy(_to_torch(ref_sd)), sd)
    fn, args = {"backbone": ("convert_backbone_state_dict", ()),
                "text": ("convert_text_encoder_state_dict", ("phoneme_embedding",)),
                "style": ("convert_style_encoder_state_dict", ("style_encoder",)),
                "dit": ("convert_dit_state_dict", ("dit",))}[part]
    assert_trees_equal(getattr(P, fn)(sd, *args), getattr(J, fn)(sd, *args))


def _asr_sd():
    torch.manual_seed(0)
    m = ASRReplica(16, 4, 32, 2, 7, 198)
    _randomize_bn_stats(m)
    return m.state_dict()


def _disc_sd():
    torch.manual_seed(1)
    return DiscriminatorReplica(8, 24, 32, 2).state_dict()


def _sv_sd():
    cfg = SVConfig(input_dim=16, emb_dim=8, channels=(24, 24, 24, 24, 72), kernel_sizes=(3, 3, 3, 3, 1),
                   dilations=(1, 2, 3, 4, 1), attention_channels=8, res2net_scale=4, se_channels=8)
    return _to_torch(_fake_speechbrain_ecapa_sd(cfg, np.random.RandomState(0)))


@pytest.mark.parametrize("model", ["asr", "discriminator", "sv"])
def test_aux_converters_match_jax(model):
    sd_t = {"asr": _asr_sd, "discriminator": _disc_sd, "sv": _sv_sd}[model]()
    sd = J.state_dict_to_numpy(sd_t)
    assert_trees_equal(P.state_dict_to_numpy(sd_t), sd)
    fn = f"convert_{model}_state_dict"
    assert_trees_equal(getattr(P, fn)(sd), getattr(J, fn)(sd))
    if model == "sv":  # the res2net scale given, as the JAX converter takes it
        assert_trees_equal(P.convert_sv_state_dict(sd, res2net_scale=4), J.convert_sv_state_dict(sd, res2net_scale=4))


def test_dit_block_count_crosscheck(ref_sd):
    n = TINY_BACKBONE.dit.n_blocks
    assert_trees_equal(P.convert_backbone_state_dict(ref_sd, n_dit_blocks=n),
                       J.convert_backbone_state_dict(ref_sd, n_dit_blocks=n))
    with pytest.raises(ValueError, match=f"{n} DiT blocks"):
        P.convert_backbone_state_dict(ref_sd, n_dit_blocks=n + 1)


@pytest.mark.parametrize("keys", [
    ["_orig_mod.module.a.w", "ema_model.module.b.w", "module._orig_mod.c.w"],
    ["online_model._orig_mod.module.d.w", "x._orig_mod.y.w", "initted", "step", "module.step"],
])
def test_nested_prefixes_clean_as_jax(keys):
    sd = {k: np.full(1, i, np.float32) for i, k in enumerate(keys)}
    got, want = P.clean_state_dict_keys(sd), J.clean_state_dict_keys(sd)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ the loader


@pytest.mark.parametrize("wrap", ["raw", "model", "student", "prefixed"])
def test_load_reference_backbone_checkpoint(tmp_path, jparams, ref_sd, wrap):
    """A raw state dict, {"model": ...}, the DMD bundle (the student is
    taken, not the model beside it), and an EMA'd DDP spelling of the keys
    all load as the JAX package loads them."""
    sd = _to_torch(ref_sd)
    other = {k: torch.zeros_like(v) for k, v in sd.items()}
    obj = {"raw": sd, "model": {"model": sd, "step": 3},
           "student": {"student_model": sd, "model": other, "optimizer": {"lr": torch.tensor(1e-5)}},
           "prefixed": {f"ema_model.module.{k}": v for k, v in sd.items()} | {"initted": torch.tensor(True)}}[wrap]
    path = str(tmp_path / "ckpt.pt")
    torch.save(obj, path)
    got = pckpt.load_reference_backbone_checkpoint(path)
    assert_trees_equal(got, jckpt.load_reference_backbone_checkpoint(path))
    assert_trees_equal(got, jparams)


def test_is_torch_checkpoint():
    assert all(pckpt.is_torch_checkpoint(f"x{s}") for s in (".pt", ".pth", ".bin"))
    assert not any(pckpt.is_torch_checkpoint(p) for p in ("x.npz", "x", "pt"))


# ------------------------------------------------------------------ entry points


@pytest.fixture(scope="module")
def pt_path(tmp_path_factory, ref_sd):
    path = str(tmp_path_factory.mktemp("ref") / "model.pth")
    torch.save({"model": _to_torch(ref_sd)}, path)
    return path


def test_smalltts_serves_a_torch_checkpoint_as_jax_does(pt_path):
    """SmallTTS(checkpoint=".pth") in both packages: the same latents on
    the same injected noise."""
    B, R, P_, TB, STEPS = 2, 64, 128, 16, 4
    rs = np.random.RandomState(2)
    ref = rs.randn(B, R, 64).astype(np.float32)
    ref_len = np.array([40, 9], np.int32)
    ph = rs.randint(1, 198, size=(B, P_)).astype(np.int32)
    ph_len = np.array([100, 31], np.int32)
    seq = np.array([TB, 11], np.int32)
    noises = rs.randn(STEPS, B, TB, 64).astype(np.float32)
    jtts = JSmallTTS(checkpoint=pt_path, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native")
    want = np.asarray(j_sample_latents(jtts.params, TINY_BACKBONE, *(jnp.asarray(a) for a in (ref, ref_len, ph, ph_len, seq)),
                                       jax.random.PRNGKey(9), num_steps=STEPS, noises=jnp.asarray(noises)))
    tts = SmallTTS(checkpoint=pt_path, cfg=PCFG, codec_cfg=PCODEC, codec="native", device="cpu")
    T = torch.from_numpy
    got = sample_latents(tts.params, PCFG, T(ref), T(ref_len), T(ph).long(), T(ph_len), T(seq),
                         num_steps=STEPS, noises=T(noises)).numpy()
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err < RTOL and float(np.abs(want).max()) > 1e-2, err
    # the waveform path runs on the same params
    wav = tts.synthesize_padded(ref, ref_len, ph, ph_len, seq, TB, noises=noises)
    assert wav.shape == (B, 1, TB * 3200) and np.isfinite(wav).all()


def test_smalltts_rejects_a_torch_checkpoint_of_another_depth(pt_path):
    deeper = dataclasses.replace(PCFG, dit=dataclasses.replace(PCFG.dit, n_blocks=PCFG.dit.n_blocks + 1))
    with pytest.raises(ValueError, match="block stacks"):
        SmallTTS(checkpoint=pt_path, cfg=deeper, codec_cfg=PCODEC, codec="native", device="cpu")


def test_train_teacher_starts_from_a_torch_checkpoint(tmp_path, pt_path):
    """train_teacher(pretrained=...) in both packages, zero steps: the same
    params (and EMA) come back; each is the checkpoint's."""
    cfg = JT.TeacherTrainConfig(num_steps=0, batch_size=2)
    jp, je = JT.train_teacher(cfg, TINY_BACKBONE, pretrained=pt_path, checkpoint_dir=str(tmp_path / "jax"))
    pp, pe = PT.train_teacher(PT.TeacherTrainConfig(num_steps=0, batch_size=2), PCFG, pretrained=pt_path,
                              checkpoint_dir=str(tmp_path / "port"), device="cpu")
    want = pckpt.flatten_pytree(params_from_jax(jax.tree.map(np.asarray, jp), PCFG))
    want_e = pckpt.flatten_pytree(params_from_jax(jax.tree.map(np.asarray, je), PCFG))
    got, got_e = pckpt.flatten_pytree(pp), pckpt.flatten_pytree(pe)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) and torch.equal(got_e[k], want_e[k]), k


def test_teacher_command_line_takes_pretrained(monkeypatch):
    seen = {}
    monkeypatch.setattr(PT, "train_teacher", lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    PT.main(["--pretrained", "ref.pt", "--steps", "2", "--batch-size", "2", "--compute-dtype", "float32"])
    assert seen["pretrained"] == "ref.pt" and seen["cfg"].num_steps == 2
    PT.main(["--steps", "2"])
    assert seen["pretrained"] is None
