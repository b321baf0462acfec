"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (what a CPU tensor takes) is held against the
Pallas kernel it replaces, run in Pallas interpret mode on the CPU, on the
same numpy inputs. Tolerances are those of tests/test_decode_attention.py:
2e-5 for attention and the norms; rope's cos/sin are transcendentals, and
XLA's float32 transcendentals are fast approximations, so its rtol is 2e-4.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.decode_attention as jda
import paddle_tpu.ops.pallas.tick_fusion as jtf
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import tick_fusion as tf

CSRC = Path(tf.__file__).resolve().parents[2] / "csrc"


@pytest.fixture
def interpret(monkeypatch):
    """Run the tick-fusion Pallas kernels through the interpreter."""
    monkeypatch.setattr(jtf, "FORCE_INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestRaggedDecodeAttention:
    @pytest.mark.parametrize("nH,Hkv,D", [(8, 8, 64), (8, 4, 64),
                                          (2, 2, 128)])
    def test_plain_matches_pallas_mixed_positions(self, nH, Hkv, D):
        """pos 0 (one visible key), pos max_len-1 (the whole window) and
        unaligned interior positions, MHA and GQA."""
        rng = np.random.RandomState(0)
        B, Smax = 4, 256
        q = rng.randn(B, nH, D).astype(np.float32)
        kc = rng.randn(B, Smax, Hkv, D).astype(np.float32)
        vc = rng.randn(B, Smax, Hkv, D).astype(np.float32)
        for pos_vals in ([0, 1, 129, 255], [37, 64, 128, 200],
                         [255, 0, 63, 191]):
            pos = np.asarray(pos_vals, np.int32)
            ref = jda.ragged_decode_attention(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                jnp.asarray(pos), interpret=True)
            out = da.ragged_decode_attention(_t(q), _t(kc), _t(vc), _t(pos))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("nH,Hkv,D", [(12, 12, 64), (16, 2, 64),
                                          (8, 1, 128)])
    def test_plain_matches_pallas_on_chunk_edges(self, nH, Hkv, D):
        """The serving window (max_len 384) with positions on the edges of
        the card kernel's key chunks (``_CHUNK`` keys a block): one key,
        the last key of a chunk, the first of the next and the one after,
        two chunks and the whole window; MHA, GQA and rep 8 at D 128."""
        C = da._CHUNK
        rng = np.random.RandomState(1)
        Smax = 384
        pos = np.asarray([0, C - 1, C, C + 1, 2 * C - 1, 2 * C, Smax - 1],
                         np.int32)
        B = len(pos)
        q = rng.randn(B, nH, D).astype(np.float32)
        kc = rng.randn(B, Smax, Hkv, D).astype(np.float32)
        vc = rng.randn(B, Smax, Hkv, D).astype(np.float32)
        ref = jda.ragged_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos), interpret=True)
        out = da.ragged_decode_attention(_t(q), _t(kc), _t(vc), _t(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)

    @pytest.mark.parametrize("nH,Hkv,D", [(8, 8, 16), (8, 4, 32),
                                          (16, 8, 16)])
    def test_plain_matches_pallas_small_head_dims(self, nH, Hkv, D):
        """Head dims below 64 (cpu_small's 8 heads of D 16, and D 32 in
        GQA), which the card kernel serves at its 32-wide instances, on
        the chunk edges; Hkv * D is the reference's 128 lanes."""
        C = da._CHUNK
        rng = np.random.RandomState(D + nH)
        Smax = 256
        pos = np.asarray([0, C - 1, C, C + 1, 2 * C, Smax - 1], np.int32)
        B = len(pos)
        q = rng.randn(B, nH, D).astype(np.float32)
        kc = rng.randn(B, Smax, Hkv, D).astype(np.float32)
        vc = rng.randn(B, Smax, Hkv, D).astype(np.float32)
        ref = jda.ragged_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos), interpret=True)
        out = da.ragged_decode_attention(_t(q), _t(kc), _t(vc), _t(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)

    def test_wrapper_rejects_bad_inputs(self):
        q = torch.zeros(2, 4, 64)
        kc = torch.zeros(2, 32, 2, 64)
        pos = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="int32"):
            da.ragged_decode_attention(q, kc, kc, pos.long())
        with pytest.raises(ValueError, match="multiple"):
            da.ragged_decode_attention(torch.zeros(2, 3, 64), kc, kc, pos)
        with pytest.raises(TypeError, match="dtype"):
            da.ragged_decode_attention(q.double(), kc.double(), kc.double(),
                                       pos)
        with pytest.raises(ValueError, match="match"):
            da.ragged_decode_attention(torch.zeros(3, 4, 64), kc, kc,
                                       torch.zeros(3, dtype=torch.int32))

    def test_cpu_tensors_take_the_plain_version(self):
        """A CPU call launches nothing: the launch count stays put."""
        before = da.ragged_decode_attention.launches
        da.ragged_decode_attention(torch.zeros(1, 2, 64),
                                   torch.zeros(1, 8, 2, 64),
                                   torch.zeros(1, 8, 2, 64),
                                   torch.zeros(1, dtype=torch.int32))
        assert da.ragged_decode_attention.launches == before


class TestTickFusion:
    def test_rms_and_add_rms_match_pallas(self, interpret):
        rng = np.random.RandomState(2)
        x = rng.randn(8, 256).astype(np.float32)
        y = rng.randn(8, 256).astype(np.float32)
        w = rng.randn(256).astype(np.float32)
        eps = 1e-6
        ref = jtf.fused_rms_norm(jnp.asarray(x), jnp.asarray(w), eps)
        rs, ro = jtf.fused_add_rms_norm(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(w), eps)
        out = tf.fused_rms_norm(_t(x), _t(w), eps)
        s, o = tf.fused_add_rms_norm(_t(x), _t(y), _t(w), eps)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(ro),
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("nH,Hkv,D", [(4, 2, 64), (2, 2, 128)])
    def test_rope_matches_pallas_ragged_positions(self, interpret, nH, Hkv,
                                                  D):
        rng = np.random.RandomState(3)
        B = 4
        zq = rng.randn(B, nH * D).astype(np.float32)
        zk = rng.randn(B, Hkv * D).astype(np.float32)
        pos = np.asarray([0, 7, 100, 255], np.int32)
        rq, rk = jtf.fused_rope_qk(jnp.asarray(zq), jnp.asarray(zk),
                                   jnp.asarray(pos), D, 10000.0)
        oq, ok = tf.fused_rope_qk(_t(zq), _t(zk), _t(pos), D, 10000.0)
        np.testing.assert_allclose(oq.numpy(), np.asarray(rq),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(ok.numpy(), np.asarray(rk),
                                   rtol=2e-4, atol=2e-4)

    def test_bf16_rounding_points(self):
        """In bf16 the normed value is rounded before the gain: the plain
        version equals that two-step rounding exactly."""
        g = torch.Generator().manual_seed(0)
        x = torch.randn(4, 256, generator=g).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(256, generator=g)).to(torch.bfloat16)
        xf = x.float()
        normed = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True)
                                   + 1e-6)).to(torch.bfloat16)
        want = (normed.float() * w.float()).to(torch.bfloat16)
        assert torch.equal(tf.fused_rms_norm(x, w, 1e-6), want)

    def test_wrappers_reject_bad_inputs(self):
        x = torch.zeros(2, 64)
        with pytest.raises(ValueError, match="w"):
            tf.fused_rms_norm(x, torch.zeros(32), 1e-6)
        with pytest.raises(TypeError, match="mixed"):
            tf.fused_add_rms_norm(x, x.bfloat16(), torch.zeros(64), 1e-6)
        with pytest.raises(ValueError, match="int32"):
            tf.fused_rope_qk(x, x, torch.zeros(2), 16, 1e4)
        with pytest.raises(ValueError, match="even"):
            tf.fused_rope_qk(x, x, torch.zeros(2, dtype=torch.int32), 7, 1e4)


def _c_signatures(library):
    """Each ``extern "C"`` function of ``csrc/<library>.cu`` -> the kinds
    of its parameters in order: "pointer", "int" or "float"."""
    src = (CSRC / f"{library}.cu").read_text()
    sigs = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for param in params.split(","):
            param = " ".join(param.split())
            if "*" in param:
                kinds.append("pointer")
            elif re.match(r"(const )?float \w+$", param):
                kinds.append("float")
            elif re.match(r"(const )?int \w+$", param):
                kinds.append("int")
            else:
                raise AssertionError(f"{name}: unparsed parameter {param!r}")
        sigs[name] = kinds
    return sigs


_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


class TestEntryPoints:
    """The wrappers' ctypes argument types against the C sources'
    signatures, so a mismatch fails here and not only on the card (ctypes
    would pass a wrong count or kind without a word)."""

    @pytest.mark.parametrize("library,name", [
        (lib, name) for lib, names in sorted(tf.ENTRIES.items())
        for name in sorted(names)])
    def test_argtypes_match_the_source(self, library, name):
        sigs = _c_signatures(library)
        assert name in sigs, f"csrc/{library}.cu has no entry point {name}"
        assert [_KIND[t] for t in tf.ENTRIES[library][name]] == sigs[name]

    @pytest.mark.parametrize("library", sorted(tf.ENTRIES))
    def test_every_entry_point_has_argtypes(self, library):
        assert sorted(_c_signatures(library)) == sorted(tf.ENTRIES[library])

    @pytest.mark.parametrize("library", ["flash_attention",
                                         "flash_attention_f32"])
    def test_flash_entries_match_the_source(self, library):
        """The flash wrappers' argtypes (``entry_argtypes``, the bf16
        names) against both libraries' entries, the fp32 instance's named
        ``flash_attention_f32_*``."""
        from paddle_tpu_torch.ops.kernels import flash_attention as fa

        sigs = _c_signatures(library)
        names = ["fwd", "bwd", "bwd_dq", "bwd_dkv"]
        assert sorted(sigs) == sorted([f"{library}_{n}" for n in names]
                                      + [f"{library}_smem"])
        for n in names:
            kinds = [_KIND[t] for t in fa.entry_argtypes(
                f"flash_attention_{n}")]
            assert kinds == sigs[f"{library}_{n}"], n
