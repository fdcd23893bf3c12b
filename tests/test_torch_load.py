"""The port's safetensors codec and HF weight I/O against the
``safetensors`` package, ``transformers`` and the JAX loader.

- The codec (``models/safetensors_io.py``) both ways: files it writes load
  with ``safetensors`` bit for bit (F32, F16, BF16, I8, I64, U8, BOOL,
  F8_E4M3, strided and empty tensors), files ``safetensors`` writes
  (with a ``__metadata__`` map) read back bit for bit, an index-sharded
  two-file directory resolves, and a corrupt header is refused (past the
  file, overlap, hole, bytes that do not match the shape, a buffer the
  tensors do not cover, an unknown dtype, not JSON, a file too short).
- ``load_hf_params`` on checkpoints saved by random-init ``transformers``
  models (Qwen2 tied and untied, Llama, Qwen3 with QK-norm, Llama-3 RoPE
  scaling, Qwen3-MoE at the tree level): the port's tree equals the JAX
  loader's bit for bit, and the port's fp32 logits match the
  ``transformers`` forward and the JAX forward within ``test_load.py``'s
  2e-4.
- Round trips: port export → JAX load, JAX export → port load (dense and
  both MoE layouts), bf16 by uint16 view; ``strict`` leftovers, the
  missing-key and shape errors, the int8 refusal, the unknown MoE layout.
- PEFT adapters: the port's files equal JAX's, and both loaders agree on
  each other's files (rsLoRA scaling included).
"""

import dataclasses
import json
import os

# transformers otherwise imports TensorFlow where it is installed: seconds
# of import for models these tests build in torch
os.environ.setdefault("USE_TF", "0")

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy as stnp
import safetensors.torch as sttorch
import torch

from senweaver_ide_tpu.models import ModelConfig as JaxModelConfig
from senweaver_ide_tpu.models import RopeScaling as JaxRopeScaling
from senweaver_ide_tpu.models import forward as jax_forward
from senweaver_ide_tpu.models import get_config as jax_get_config
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models.load import export_hf_params as jax_export
from senweaver_ide_tpu.models.load import load_hf_params as jax_load
from senweaver_ide_tpu.training import lora as jax_lora
from senweaver_ide_tpu_torch.models import (ModelConfig, RopeScaling,
                                            available_hf_keys,
                                            export_hf_params, forward,
                                            get_config, init_params,
                                            load_hf_params,
                                            params_from_numpy)
from senweaver_ide_tpu_torch.models import safetensors_io as sio
from senweaver_ide_tpu_torch.training import (export_peft_adapter,
                                              init_lora, load_peft_adapter)
from senweaver_ide_tpu_torch.training.trainer import flatten_params

LOGITS_TOL = 2e-4          # tests/test_load.py's HF parity tolerance
IDS = np.asarray([[1, 5, 9, 42, 7, 3, 100, 2]])


def _bits(x) -> np.ndarray:
    """An array's bits as a numpy array: bf16 (torch or ml_dtypes) as
    uint16, fp8 as uint8, everything else as is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x


def assert_trees_equal(port, ref):
    got, want = dict(flatten_params(port)), dict(flatten_params(ref))
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = _bits(got[k]), _bits(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _read(path):
    """Every tensor of one file, through the port's codec, on the CPU."""
    with sio.SafetensorsReader([path]) as r:
        return {k: r.get(k) for k in r.keys()}


def _bridge(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


# -- the codec ----------------------------------------------------------------

def _codec_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 127, (7,), generator=g, dtype=torch.int8),
        "i64": torch.tensor(123456789012, dtype=torch.int64),
        "u8": torch.arange(5, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "f8": torch.randn(2, 3, generator=g).to(torch.float8_e4m3fn),
        "strided": torch.randn(4, 6, generator=g).T,
        "empty": torch.zeros(0, 3),
        "f64": torch.randn(2, generator=g, dtype=torch.float64),
        "i16": torch.tensor([-3, 4], dtype=torch.int16),
        "i32": torch.tensor([[1, -2]], dtype=torch.int32),
    }


def test_codec_files_load_in_safetensors(tmp_path):
    tensors = _codec_tensors()
    path = str(tmp_path / "x.safetensors")
    sio.save_file(tensors, path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0                          # header padded to 8
    got = sttorch.load_file(path)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(t.contiguous()))
    no_f8 = {k: v for k, v in tensors.items() if k != "f8"}
    path2 = str(tmp_path / "y.safetensors")
    sio.save_file(no_f8, path2)
    as_np = stnp.load_file(path2)
    for k, t in no_f8.items():
        np.testing.assert_array_equal(_bits(as_np[k]), _bits(t.contiguous()))
    back = _read(path)
    for k, t in tensors.items():
        np.testing.assert_array_equal(_bits(back[k]), _bits(t.contiguous()))


def test_codec_reads_safetensors_files(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "bf16": rng.normal(size=(2, 6)).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 127, size=(9,)).astype(np.int8),
    }
    path = str(tmp_path / "a.safetensors")
    stnp.save_file(arrays, path, metadata={"who": "safetensors"})
    got = _read(path)
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(a), err_msg=k)
    assert got["bf16"].dtype == torch.bfloat16
    f8 = {"w": torch.randn(4, 4).to(torch.float8_e4m3fn)}
    sttorch.save_file(f8, str(tmp_path / "f8.safetensors"))
    back = _read(str(tmp_path / "f8.safetensors"))["w"]
    assert back.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bits(back), _bits(f8["w"]))


def test_codec_reads_sharded_index_dir(tmp_path):
    """A two-file checkpoint written by safetensors with an index: the
    port's loader resolves it and equals the JAX loader."""
    jcfg, tcfg = jax_get_config("tiny-test"), get_config("tiny-test")
    export_hf_params(init_params(tcfg, torch.Generator().manual_seed(3),
                                 device="cpu"), tcfg, str(tmp_path))
    tensors = stnp.load_file(str(tmp_path / "model.safetensors"))
    keys = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": keys[:len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for fname, ks in shards.items():
        stnp.save_file({k: tensors[k] for k in ks}, str(tmp_path / fname))
        weight_map.update({k: fname for k in ks})
    (tmp_path / "model.safetensors").unlink()
    (tmp_path / sio.INDEX_NAME).write_text(
        json.dumps({"weight_map": weight_map}))
    assert sio.safetensor_files(str(tmp_path)) == [
        str(tmp_path / f) for f in sorted(shards)]
    assert available_hf_keys(str(tmp_path)) == keys
    assert_trees_equal(load_hf_params(str(tmp_path), tcfg, device="cpu"),
                       jax_load(str(tmp_path), jcfg))


def _write_raw(path, header, data: bytes, length=None):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write((len(blob) if length is None else length).to_bytes(
            8, "little"))
        f.write(blob + data)


@pytest.mark.parametrize("case,match", [
    ("past_file", "runs past"),
    ("overlap", "overlap"),
    ("hole", "hole"),
    ("shape_bytes", "needs 16 bytes"),
    ("short_buffer", "cover"),
    ("dtype", "bad header entry"),
    ("not_json", "not JSON"),
    ("tiny_file", "too short"),
])
def test_codec_rejects_bad_headers(tmp_path, case, match):
    path = str(tmp_path / "bad.safetensors")
    e = lambda dt, shape, a, b: {"dtype": dt, "shape": shape,  # noqa: E731
                                 "data_offsets": [a, b]}
    if case == "past_file":
        _write_raw(path, {"a": e("F32", [2], 0, 8)}, b"\0" * 8,
                   length=10_000)
    elif case == "overlap":
        _write_raw(path, {"a": e("F32", [2], 0, 8),
                          "b": e("F32", [2], 4, 12)}, b"\0" * 12)
    elif case == "hole":
        _write_raw(path, {"a": e("F32", [1], 0, 4),
                          "b": e("F32", [1], 8, 12)}, b"\0" * 12)
    elif case == "shape_bytes":
        _write_raw(path, {"a": e("F32", [4], 0, 8)}, b"\0" * 8)
    elif case == "short_buffer":
        _write_raw(path, {"a": e("F32", [2], 0, 8)}, b"\0" * 16)
    elif case == "dtype":
        _write_raw(path, {"a": e("F12", [2], 0, 8)}, b"\0" * 8)
    elif case == "not_json":
        with open(path, "wb") as f:
            f.write((4).to_bytes(8, "little") + b"{{{{")
    else:
        with open(path, "wb") as f:
            f.write(b"\1\2\3")
    with pytest.raises(ValueError, match=match):
        _read(path)


# -- HF checkpoints saved by transformers -------------------------------------

def _family(name):
    """(transformers config, matching ModelConfig kwargs)."""
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=128, rms_norm_eps=1e-6)
    ours = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, head_dim=16, max_seq_len=128)
    if name in ("qwen2", "qwen2-tied"):
        tied = name == "qwen2-tied"
        hf = transformers.Qwen2Config(num_key_value_heads=2,
                                      rope_theta=10000.0,
                                      tie_word_embeddings=tied, **common)
        return (transformers.Qwen2ForCausalLM(hf),
                dict(ours, name=name, num_kv_heads=2, rope_theta=10000.0,
                     qkv_bias=True, tie_word_embeddings=tied))
    if name == "llama":
        hf = transformers.LlamaConfig(num_key_value_heads=4,
                                      rope_theta=100000.0,
                                      attention_bias=False,
                                      tie_word_embeddings=False, **common)
        return (transformers.LlamaForCausalLM(hf),
                dict(ours, name=name, num_kv_heads=4, rope_theta=100000.0,
                     qkv_bias=False))
    if name == "qwen3":
        hf = transformers.Qwen3Config(num_key_value_heads=2, head_dim=16,
                                      rope_theta=1_000_000.0,
                                      tie_word_embeddings=False,
                                      attention_bias=False, **common)
        return (transformers.Qwen3ForCausalLM(hf),
                dict(ours, name=name, num_kv_heads=2,
                     rope_theta=1_000_000.0, qkv_bias=False, qk_norm=True))
    assert name == "llama3-scaled"
    hf = transformers.LlamaConfig(
        num_key_value_heads=2, rope_theta=100000.0, attention_bias=False,
        tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
        **dict(common, rms_norm_eps=1e-5))
    return (transformers.LlamaForCausalLM(hf),
            dict(ours, name=name, num_kv_heads=2, rope_theta=100000.0,
                 qkv_bias=False, rms_norm_eps=1e-5, rope_scaling="llama3"))


def _configs(kw):
    kw = dict(kw)
    scaled = kw.pop("rope_scaling", None)
    rs = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_position=32)
    jcfg = JaxModelConfig(**kw, dtype=jnp.float32,
                          matmul_precision="highest",
                          **({"rope_scaling": JaxRopeScaling(**rs)}
                             if scaled else {}))
    tcfg = ModelConfig(**kw, dtype=torch.float32,
                       matmul_precision="highest",
                       **({"rope_scaling": RopeScaling(**rs)}
                          if scaled else {}))
    return jcfg, tcfg


@pytest.mark.parametrize("family", ["qwen2", "qwen2-tied", "llama", "qwen3",
                                    "llama3-scaled"])
def test_hf_checkpoint_parity(tmp_path, family):
    torch.manual_seed(0)
    model, kw = _family(family)
    model = model.eval().to(torch.float32)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    jcfg, tcfg = _configs(kw)
    ours = load_hf_params(str(tmp_path), tcfg, device="cpu")
    assert ours["embed"].device.type == "cpu"
    assert ours["layers"]["wq"].dtype == torch.float32
    ref = jax_load(str(tmp_path), jcfg)
    assert_trees_equal(ours, ref)
    ids = IDS % 512
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
        got = forward(ours, tcfg, torch.tensor(ids)).numpy()
    jgot, _ = jax_forward(ref, jcfg, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


def test_hf_qwen3_moe_checkpoint_tree(tmp_path):
    """Qwen3-MoE's ``mlp.experts`` layout from a transformers checkpoint:
    the port's tree equals the JAX loader's (the port's forward has no
    MoE yet, so the tree is the check)."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.Qwen3MoeConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=4, num_experts_per_tok=2, decoder_sparse_step=1,
        norm_topk_prob=True, max_position_embeddings=128,
        rope_theta=1_000_000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_bias=False, mlp_only_layers=[])
    torch.manual_seed(0)
    transformers.Qwen3MoeForCausalLM(hf).save_pretrained(
        str(tmp_path), safe_serialization=True)
    jcfg, tcfg = _configs(dict(
        name="qwen3-moe", vocab_size=512, hidden_size=64,
        intermediate_size=48, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, max_seq_len=128, rope_theta=1_000_000.0,
        qkv_bias=False, qk_norm=True, num_experts=4, num_experts_per_tok=2,
        expert_capacity_factor=8.0, moe_layout="qwen3"))
    ours = load_hf_params(str(tmp_path), tcfg, device="cpu")
    assert tuple(ours["layers"]["w_gate"].shape) == (2, 4, 64, 48)
    assert_trees_equal(ours, jax_load(str(tmp_path), jcfg))


# -- round trips between the two packages --------------------------------------

@pytest.mark.parametrize("name,layout", [
    ("tiny-test", None), ("tiny-moe-test", "mixtral"),
    ("tiny-moe-test", "qwen3")])
def test_jax_export_loads_in_port(tmp_path, name, layout):
    jcfg, tcfg = jax_get_config(name), get_config(name)
    if layout is not None:
        jcfg = dataclasses.replace(jcfg, moe_layout=layout, qkv_bias=False)
        tcfg = dataclasses.replace(tcfg, moe_layout=layout, qkv_bias=False)
    if layout is None:      # a JAX tree without compiling JAX's init
        export_hf_params(init_params(tcfg, torch.Generator().manual_seed(5),
                                     device="cpu"), tcfg, str(tmp_path / "s"))
        jp = jax_load(str(tmp_path / "s"), jcfg)
    else:
        jp = jax_init_params(jcfg, jax.random.PRNGKey(5))
    jax_export(jp, jcfg, str(tmp_path))
    ours = load_hf_params(str(tmp_path), tcfg, device="cpu")
    assert_trees_equal(ours, jp)
    assert_trees_equal(ours, jax_load(str(tmp_path), jcfg))


@pytest.mark.parametrize("name,layout", [
    ("tiny-test", None), ("tiny-moe-test", "mixtral"),
    ("tiny-moe-test", "qwen3")])
def test_port_export_loads_in_jax(tmp_path, name, layout):
    jcfg, tcfg = jax_get_config(name), get_config(name)
    if layout is not None:
        jcfg = dataclasses.replace(jcfg, moe_layout=layout, qkv_bias=False)
        tcfg = dataclasses.replace(tcfg, moe_layout=layout, qkv_bias=False)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(6))
    ours = _bridge(jp)
    export_hf_params(ours, tcfg, str(tmp_path / "port"))
    jax_export(jp, jcfg, str(tmp_path / "jax"))
    # same key set and the same bytes as the JAX package's file
    a = stnp.load_file(str(tmp_path / "port" / "model.safetensors"))
    b = stnp.load_file(str(tmp_path / "jax" / "model.safetensors"))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_trees_equal(ours, jax_load(str(tmp_path / "port"), jcfg))
    assert_trees_equal(load_hf_params(str(tmp_path / "port"), tcfg,
                                      device="cpu"), ours)


def test_bf16_round_trip_both_ways(tmp_path):
    """bf16 trees: the port's export reads back in JAX as ml_dtypes bf16
    and the port reads JAX's; compared by uint16 view."""
    jcfg = dataclasses.replace(jax_get_config("tiny-test"),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_config("tiny-test"), dtype=torch.bfloat16)
    ours = init_params(tcfg, torch.Generator().manual_seed(7), device="cpu")
    export_hf_params(ours, tcfg, str(tmp_path / "port"))
    jp = jax_load(str(tmp_path / "port"), jcfg)
    assert jp["layers"]["wq"].dtype == jnp.bfloat16
    assert_trees_equal(ours, jp)
    # JAX's export of that bf16 tree reads back in the port
    jax_export(jp, jcfg, str(tmp_path / "jax"))
    back = load_hf_params(str(tmp_path / "jax"), tcfg, device="cpu")
    assert back["layers"]["wq"].dtype == torch.bfloat16
    assert_trees_equal(back, jp)
    # an fp32 checkpoint cast to bf16 on load rounds as JAX's astype does
    f32 = get_config("tiny-test")
    export_hf_params(init_params(f32, torch.Generator().manual_seed(8),
                                 device="cpu"), f32, str(tmp_path / "f32"))
    assert_trees_equal(
        load_hf_params(str(tmp_path / "f32"), tcfg, device="cpu"),
        jax_load(str(tmp_path / "f32"), jcfg))


def test_port_round_trip_forward_identical(tmp_path):
    cfg = get_config("tiny-test")
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    export_hf_params(params, cfg, str(tmp_path))
    loaded = load_hf_params(str(tmp_path), cfg, device="cpu")
    assert_trees_equal(loaded, params)
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(forward(loaded, cfg, toks),
                           forward(params, cfg, toks))


def test_qk_norm_round_trip(tmp_path):
    cfg = dataclasses.replace(get_config("tiny-test"), name="tiny-qk",
                              qkv_bias=False, qk_norm=True)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    g = torch.Generator().manual_seed(4)
    for name in ("q_norm", "k_norm"):       # distinct, so a swap shows
        params["layers"][name] = torch.rand(
            params["layers"][name].shape, generator=g) + 0.5
    export_hf_params(params, cfg, str(tmp_path))
    keys = available_hf_keys(str(tmp_path))
    assert "model.layers.1.self_attn.k_norm.weight" in keys
    assert_trees_equal(load_hf_params(str(tmp_path), cfg, device="cpu"),
                       params)


# -- refusals -------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = get_config("tiny-test")
    d = tmp_path_factory.mktemp("exported")
    export_hf_params(init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"), cfg, str(d))
    return cfg, d


def test_strict_rejects_leftover(tmp_path, exported):
    cfg, d = exported
    tensors = _read(str(d / "model.safetensors"))
    tensors["model.layers.0.self_attn.unknown.weight"] = torch.zeros(2, 2)
    tensors["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    sio.save_file(tensors, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="1 unconsumed"):
        load_hf_params(str(tmp_path), cfg, device="cpu")
    loose = load_hf_params(str(tmp_path), cfg, device="cpu", strict=False)
    assert set(loose) == {"embed", "layers", "final_norm", "lm_head"}


def test_shape_and_missing_key_errors(exported):
    cfg, d = exported
    with pytest.raises(ValueError, match="shape"):
        load_hf_params(str(d), dataclasses.replace(cfg,
                                                   intermediate_size=64),
                       device="cpu")


def test_missing_lm_head_reported(tmp_path):
    cfg = get_config("tiny-test")
    tied = dataclasses.replace(cfg, tie_word_embeddings=True)
    export_hf_params(init_params(tied, torch.Generator().manual_seed(0),
                                 device="cpu"), tied, str(tmp_path))
    assert "lm_head.weight" not in available_hf_keys(str(tmp_path))
    with pytest.raises(KeyError, match="lm_head"):
        load_hf_params(str(tmp_path), cfg, device="cpu")
    assert "lm_head" not in load_hf_params(str(tmp_path), tied,
                                           device="cpu")


def test_export_refuses_int8_and_unknown_moe_layout(tmp_path):
    cfg = get_config("tiny-test")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["layers"]["wq"] = params["layers"]["wq"].to(torch.int8)
    with pytest.raises(TypeError, match="int8"):
        export_hf_params(params, cfg, str(tmp_path))
    moe = dataclasses.replace(jax_get_config("tiny-moe-test"),
                              moe_layout="qwen3-moe")
    with pytest.raises(ValueError, match="unknown moe_layout"):
        export_hf_params(_bridge(jax_init_params(moe,
                                                 jax.random.PRNGKey(0))),
                         dataclasses.replace(get_config("tiny-moe-test"),
                                             moe_layout="qwen3-moe"),
                         str(tmp_path))
    assert not os.path.exists(tmp_path / "model.safetensors")


def test_load_refuses_without_a_card(monkeypatch, exported):
    cfg, d = exported
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_hf_params(str(d), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_peft_adapter(str(d), cfg)


# -- PEFT adapters ----------------------------------------------------------------

def test_peft_adapter_files_and_loads_match_jax(tmp_path):
    jcfg, tcfg = jax_get_config("tiny-test"), get_config("tiny-test")
    targets = ("wq", "wv", "w_down")
    # seeded A and B (B nonzero, so the transposes show), in init_lora's
    # shapes: (L, in, r) and (L, r, out)
    rng = np.random.default_rng(2)
    jl = {"layers": {}}
    for t in targets:
        d_in, d_out = {"wq": (64, 64), "wv": (64, 32),
                       "w_down": (128, 64)}[t]
        jl["layers"][t + "_lora_a"] = jnp.asarray(
            rng.normal(size=(2, d_in, 4)).astype(np.float32))
        jl["layers"][t + "_lora_b"] = jnp.asarray(
            rng.normal(size=(2, 4, d_out)).astype(np.float32))
    ours = _bridge(jl)
    export_peft_adapter(ours, tcfg, str(tmp_path / "port"))
    jax_lora.export_peft_adapter(jl, jcfg, str(tmp_path / "jax"))
    a = stnp.load_file(str(tmp_path / "port" / "adapter_model.safetensors"))
    b = stnp.load_file(str(tmp_path / "jax" / "adapter_model.safetensors"))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "port" / "adapter_config.json") as f:
        port_meta = json.load(f)
    with open(tmp_path / "jax" / "adapter_config.json") as f:
        assert port_meta == json.load(f)
    for src in ("port", "jax"):
        assert_trees_equal(
            load_peft_adapter(str(tmp_path / src), tcfg, device="cpu"),
            jax_lora.load_peft_adapter(str(tmp_path / src), jcfg))
    # rsLoRA scaling alpha / sqrt(r), on both sides
    port_meta.update(lora_alpha=8, use_rslora=True)
    with open(tmp_path / "port" / "adapter_config.json", "w") as f:
        json.dump(port_meta, f)
    assert_trees_equal(
        load_peft_adapter(str(tmp_path / "port"), tcfg, device="cpu"),
        jax_lora.load_peft_adapter(str(tmp_path / "port"), jcfg))


def test_peft_adapter_errors(tmp_path):
    tcfg = get_config("tiny-test")
    with pytest.raises(ValueError, match="no LoRA adapter leaves"):
        export_peft_adapter({"layers": {}}, tcfg, str(tmp_path / "e"))
    lora = init_lora(tcfg, torch.Generator().manual_seed(0), rank=4,
                     device="cpu")
    export_peft_adapter(lora, tcfg, str(tmp_path / "ok"))
    short = dataclasses.replace(tcfg, num_layers=tcfg.num_layers + 1)
    with pytest.raises(ValueError, match="covers layers"):
        load_peft_adapter(str(tmp_path / "ok"), short, device="cpu")
    wide = dataclasses.replace(tcfg, hidden_size=tcfg.hidden_size * 2)
    with pytest.raises(ValueError, match="lora_A shape"):
        load_peft_adapter(str(tmp_path / "ok"), wide, device="cpu")
    back = load_peft_adapter(str(tmp_path / "ok"), tcfg, device="cpu")
    assert_trees_equal(back, lora)
