"""Sampling: the port's threefry ``row_uniforms`` bitwise against JAX, the
top-k/top-p filter's plain versions against the JAX Pallas kernel
(interpret mode) and the JAX sort-based oracle, the CPU model of the CUDA
filter's search (radix top-k, estimate, multi-candidate nucleus sweeps)
bitwise against the bisection, the cluster-size plan, the inverse-CDF draw
and ``sample_tokens`` against JAX, the wrappers' CPU dispatch, and on a
card the CUDA filter and draw kernels bitwise against their plain
versions."""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dependency (requirements-dev.txt)
    given = settings = st = None

try:
    import jax.numpy as jnp
    from repro.kernels.fused_lm_head import ref as jhead
    from repro.kernels.fused_sampling import kernel as jkernel
    from repro.kernels.fused_sampling import ref as jsref
    from repro.serving.sampling import sample_tokens as jax_sample_tokens
except ImportError:         # the card's machine: only the gpu tests run
    jnp = None
from repro_torch.kernels.fused_lm_head import ref as head
from repro_torch.kernels.fused_sampling import ops, ref as sref
from repro_torch.serving.sampling import SamplingParams, sample_tokens

torch.set_num_threads(2)


def test_row_uniforms_bitwise_match_jax():
    seeds = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint64)
    s, p = np.meshgrid(seeds, np.arange(4096), indexing="ij")
    s, p = s.ravel(), p.ravel()
    want = np.asarray(jhead.row_uniforms(jnp.asarray(s.astype(np.uint32)),
                                         jnp.asarray(p.astype(np.int32))))
    got = head.row_uniforms(torch.from_numpy(s.astype(np.int64)),
                            torch.from_numpy(p.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def _rows(seed, s, v, scale=3.0):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(s, v)) * scale).astype(np.float32)
    lg[1, :7] = lg[1, 7]                          # ties at the k-th value
    lg[2, ::3] = -np.inf                          # pre-masked entries
    lg[3] = -np.inf                               # fully masked row
    top_k = np.array([40, 5, 0, 3, 1, 0, v + 9, 17][:s], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.9, 0.3, 0.95, 0.8, 1.0][:s],
                     np.float32)
    return lg, top_k, top_p


def _nucleus_margin(lg, top_k, top_p, row):
    """|SG - T| at the JAX oracle's nucleus boundary of one row, over Z."""
    lg_r, tk, tp = (jnp.asarray(lg[row:row + 1]), jnp.asarray(top_k[row:row + 1]),
                    jnp.asarray(top_p[row:row + 1]))
    k_only = np.asarray(jsref.filter_logits_ref(lg_r, tk, jnp.ones_like(tp)))
    u, z = jsref.softmax_mass_stats(jnp.asarray(k_only))
    t = float(jsref.nucleus_target(tp, z)[0])
    vals = np.unique(k_only[np.isfinite(k_only)])
    sg = [float(jsref.strict_greater_mass(jnp.asarray(k_only), u,
                                          jnp.asarray([v], jnp.float32))[0])
          for v in vals]
    return min(abs(x - t) for x in sg) / max(float(z[0]), 1e-30)


@pytest.mark.parametrize("seed,v", [(0, 512), (1, 1000), (2, 128256 // 64)])
def test_filter_plain_matches_pallas_and_oracle(seed, v):
    lg, top_k, top_p = _rows(seed, 8, v)
    t_args = (torch.from_numpy(lg), torch.from_numpy(top_k),
              torch.from_numpy(top_p))
    bisect = sref.filter_logits_bisect(*t_args).numpy()
    oracle = sref.filter_logits_ref(*t_args).numpy()
    np.testing.assert_array_equal(bisect.view(np.int32), oracle.view(np.int32))
    j_args = (jnp.asarray(lg), jnp.asarray(top_k), jnp.asarray(top_p))
    pallas = np.asarray(jkernel.filter_logits(*j_args, interpret=True))
    j_oracle = np.asarray(jsref.filter_logits_ref(*j_args))
    for want in (pallas, j_oracle):
        for row in range(lg.shape[0]):
            if np.array_equal(np.isfinite(bisect[row]), np.isfinite(want[row])):
                np.testing.assert_array_equal(
                    bisect[row][np.isfinite(bisect[row])],
                    want[row][np.isfinite(want[row])])
                continue
            margin = _nucleus_margin(lg, top_k, top_p, row)
            print(f"row {row}: masks differ; nucleus-boundary margin "
                  f"|SG - T| / Z = {margin:.3e}")
            assert margin < 1e-6, (row, margin)


def test_canonical_tiled_sum_is_a_halving_tree_and_left_fold():
    x = torch.from_numpy(np.random.default_rng(3).random((2, 300),
                                                         np.float32))
    parts = sref.tile_partial_sums(x)
    assert parts.shape == (2, 3)
    tile = np.zeros((2, 384), np.float32)
    tile[:, :300] = x.numpy()
    for t in range(3):
        y = tile[:, t * 128:(t + 1) * 128]
        while y.shape[1] > 1:
            h = y.shape[1] // 2
            y = y[:, :h] + y[:, h:]
        np.testing.assert_array_equal(parts[:, t].numpy(), y[:, 0])
    acc = np.zeros((2,), np.float32)
    for t in range(3):
        acc = (acc + parts[:, t].numpy()).astype(np.float32)
    np.testing.assert_array_equal(sref.tiled_row_sum(x).numpy(), acc)


def test_bit_keys_are_monotone_and_invertible():
    f = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-40, 2.0, np.inf], np.float32)
    k = sref.float_to_key(torch.from_numpy(f))
    assert (k[1:] > k[:-1]).all()
    back = sref.key_to_float(k).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), f.view(np.uint32))
    want = np.asarray(jsref.float_to_key(jnp.asarray(f))).astype(np.int64)
    np.testing.assert_array_equal(k.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_tokens_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(6, 700)) * 2).astype(np.float32)
    lg[2, 100:] = -np.inf
    lg[4] = -np.inf                                 # all masked -> token 0
    rs = rng.random(6).astype(np.float32)
    rs[5] = 0.0
    want = np.asarray(jhead.draw_tokens(jnp.asarray(lg), jnp.asarray(rs)))
    got = head.draw_tokens(torch.from_numpy(lg), torch.from_numpy(rs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0


def test_draw_tokens_prefix_is_tile_fold_plus_sequential_lane_sum():
    rng = np.random.default_rng(7)
    lg = (rng.normal(size=(5, 300)) * 2).astype(np.float32)
    rs = rng.random(5).astype(np.float32)
    got = head.draw_tokens(torch.from_numpy(lg), torch.from_numpy(rs)).numpy()
    u = np.zeros((5, 384), np.float32)
    u[:, :300] = np.exp(lg - lg.max(-1, keepdims=True))
    parts = sref.tile_partial_sums(torch.from_numpy(u)).numpy()
    for r in range(5):
        z = np.float32(0)
        for p in parts[r]:
            z = np.float32(z + p)
        target = np.float32(rs[r] * z)
        acc, want = np.float32(0), 0
        for t in range(3):
            c = np.float32(0)
            for j in range(128):
                c = np.float32(c + u[r, t * 128 + j])
                if np.float32(acc + c) > target:
                    want = t * 128 + j
                    break
            else:
                acc = np.float32(acc + parts[r, t])
                continue
            break
        assert got[r] == want, (r, got[r], want)


@pytest.mark.parametrize("filtered,fused", [(False, True), (True, True),
                                            (True, False)])
def test_sample_tokens_matches_jax(filtered, fused):
    rng = np.random.default_rng(4)
    s, v = 8, 512
    logits = (rng.normal(size=(s, v)) * 2).astype(np.float32)
    seeds = np.array([0, 1, 7, 2 ** 31, 2 ** 32 - 1, 5, 5, 9], np.uint64)
    pos = rng.integers(0, 4096, s).astype(np.int32)
    temps = np.array([0, 0.8, 1.0, 1.3, 0.5, 0, 0.9, 2.0], np.float32)
    top_k = np.array([0, 40, 5, 0, 1, 0, 20, 100], np.int32)
    top_p = np.array([1, 0.9, 1, 0.7, 1, 1, 0.95, 0.5], np.float32)
    want = np.asarray(jax_sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(pos), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p), filtered=filtered, fused=fused))
    got = sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(pos), torch.from_numpy(temps),
        torch.from_numpy(top_k), torch.from_numpy(top_p), filtered=filtered,
        fused=fused).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = logits.argmax(-1)
    assert (got[temps == 0] == greedy[temps == 0]).all()


def test_sampling_params_validate_like_jax():
    for bad in (dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(seed=2 ** 32)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    sp = SamplingParams(temperature=0.8, top_k=40)
    assert not sp.greedy and sp.filtered
    assert SamplingParams().greedy and not SamplingParams().filtered


def test_filter_wrapper_takes_plain_path_on_cpu():
    ops.LAUNCHES["filter_logits"] = 0
    lg, top_k, top_p = _rows(5, 4, 256)
    args = (torch.from_numpy(lg), torch.from_numpy(top_k),
            torch.from_numpy(top_p))
    assert torch.equal(ops.filter_logits(*args),
                       sref.filter_logits_bisect(*args))
    assert ops.LAUNCHES["filter_logits"] == 0


def test_draw_wrapper_takes_plain_path_on_cpu():
    ops.LAUNCHES["draw_tokens"] = 0
    lg, _, _ = _rows(8, 4, 256)
    seeds = torch.tensor([0, 5, 2 ** 32 - 1, 9])
    pos = torch.tensor([7, 0, 2 ** 31 - 1, 130], dtype=torch.int32)
    assert torch.equal(ops.draw_tokens(torch.from_numpy(lg), seeds, pos),
                       head.draw_tokens(torch.from_numpy(lg),
                                        head.row_uniforms(seeds, pos)))
    assert ops.LAUNCHES["draw_tokens"] == 0


@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_draw_wrapper_equals_the_plain_draw_of_the_plain_uniforms(pos_dtype):
    """Seeds and positions as the engines pass them (int64 seeds, int32 or
    int64 positions), against ``draw_tokens(lg, row_uniforms(...))``."""
    lg, top_k, top_p = _rows(10, 8, 1000)
    lg_f = sref.filter_logits_bisect(torch.from_numpy(lg),
                                     torch.from_numpy(top_k),
                                     torch.from_numpy(top_p))
    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 11, 11, 3, 4])
    pos = torch.tensor([0, 2 ** 31 - 1, 5, 5, 1, 2, 1000, 64],
                       dtype=pos_dtype)
    got = ops.draw_tokens(lg_f, seeds, pos)
    assert got.dtype == torch.int32
    assert torch.equal(got, head.draw_tokens(lg_f,
                                             head.row_uniforms(seeds, pos)))


@pytest.mark.parametrize("bad", ["seeds int32", "seeds float", "seeds [S-1]",
                                 "positions float", "positions uint8",
                                 "positions [S-1]", "positions [S, 1]"])
def test_draw_wrapper_raises_on_wrong_seeds_or_positions(bad):
    lg = torch.zeros(4, 256)
    keys = {"seeds": torch.arange(4), "positions": torch.arange(4).int()}
    name, what = bad.split(" ", 1)
    t = keys[name]
    keys[name] = {"int32": t.int(), "float": t.float(), "uint8": t.byte(),
                  "[S-1]": t[:3], "[S, 1]": t[:, None]}[what]
    with pytest.raises(ValueError, match=name):
        ops.draw_tokens(lg, keys["seeds"], keys["positions"])


def test_device_uniforms_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="card"):
        ops.device_row_uniforms(torch.arange(4), torch.arange(4))


# ------------------------------------- the CUDA filter's search on the CPU ---
ADVERSARIAL = ("ties at the k-th value across a tile edge", "k = 1",
               "k >= V", "all -inf", "one finite entry",
               "T clamped to T_FLOOR", "nucleus edge in a dense tail",
               "top-k off, top-p 0.95")


def adversarial_row(kind: str, v: int, seed: int = 0):
    """One row [1, v] of logits and its (top_k, top_p), each a corner the
    kernel's search has to get bit for bit."""
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(1, v)) * 3.0).astype(np.float32)
    k, p = 40, 0.95
    if kind.startswith("ties"):
        lg[0, 100:160] = lg[0].max() - 1.0     # 60 equal values over tile 0/1
        k = 20
    elif kind == "k = 1":
        k, p = 1, 0.9
    elif kind == "k >= V":
        k, p = v + 3, 0.99
    elif kind == "all -inf":
        lg[:] = -np.inf
    elif kind == "one finite entry":
        lg[:] = -np.inf
        lg[0, v // 3] = 2.5
        k = 0
    elif kind == "T clamped to T_FLOOR":
        k, p = 0, 1e-40                        # top_p * Z below T_FLOOR
    elif kind == "nucleus edge in a dense tail":
        lg[0] = -4.0 + 1e-6 * rng.normal(size=v).astype(np.float32)
        lg[0, :8] = [6.0, 5.5, 5.0, 4.5, 4.0, 3.5, 3.0, 2.5]
        k, p = 0, 0.9
    elif kind == "top-k off, top-p 0.95":
        k = 0
    return lg, np.array([k], np.int32), np.array([p], np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("v", [50304, 128256])
@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_search_model_bitwise_matches_bisect(kind, v):
    args = [torch.from_numpy(a) for a in adversarial_row(kind, v)]
    want = sref.filter_logits_bisect(*args)
    np.testing.assert_array_equal(_bits(sref.filter_logits_search(*args)),
                                  _bits(want))
    if kind == "T clamped to T_FLOOR":          # only the max survives
        assert int(torch.isfinite(want).sum()) == 1


@pytest.mark.parametrize("scale", [0.0, 0.5, 0.999, 1.001, 2.0])
def test_search_model_exact_however_wrong_the_estimate(scale):
    """Estimates off by a little (the kernel's usual miss) or a lot only
    cost exact sweeps: the threshold stays the bisection's."""
    lg, top_k, top_p = _rows(12, 8, 2000)
    args = (torch.from_numpy(lg), torch.from_numpy(top_k),
            torch.from_numpy(top_p))
    want = _bits(sref.filter_logits_bisect(*args))
    for cands in (2, 3, 16):
        got = sref.filter_logits_search(*args, cands=cands,
                                        estimate_scale=scale)
        np.testing.assert_array_equal(_bits(got), want)


if st is not None:
    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), s=st.integers(1, 3),
           v=st.integers(1, 700), ties=st.booleans(), masked=st.booleans(),
           cands=st.sampled_from([2, 3, 8, 16]),
           scale=st.sampled_from([1.0, 0.5, 2.0]))
    def test_search_model_property_sweep(seed, s, v, ties, masked, cands,
                                         scale):
        rng = np.random.default_rng(seed)
        lg = (rng.normal(size=(s, v)) * rng.choice([0.5, 3.0, 20.0])
              ).astype(np.float32)
        if ties:
            lg = np.round(lg)                  # ties everywhere, k-th too
        if masked:
            lg[rng.random(size=lg.shape) < 0.4] = -np.inf
        top_k = rng.integers(-1, v + 3, size=s).astype(np.int32)
        top_p = rng.choice([1e-40, 0.3, 0.9, 0.99, 1.0],
                           size=s).astype(np.float32)
        args = (torch.from_numpy(lg), torch.from_numpy(top_k),
                torch.from_numpy(top_p))
        np.testing.assert_array_equal(
            _bits(sref.filter_logits_search(*args, cands=cands,
                                            estimate_scale=scale)),
            _bits(sref.filter_logits_bisect(*args)))
else:
    def test_search_model_property_sweep():
        pytest.importorskip("hypothesis")


def test_kth_key_radix_is_the_kth_largest_key():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, size=(6, 3000))
                            .astype(np.int64))
    keys[1] = keys[1] % 7 + 0x80000000        # heavy ties
    keys[2, :2000] = 0xFFFFFFFF                # above TOP_KEY: clamped
    k = torch.tensor([1, 5, 40, 2999, 3000, 1234])
    got = sref.kth_key_radix(keys, k)
    desc = keys.sort(dim=1, descending=True).values
    want = desc.gather(1, (k - 1)[:, None])[:, 0].clamp_max(sref.TOP_KEY)
    assert torch.equal(got, want)


def test_first_candidates_ascend_around_the_estimate():
    key = torch.tensor([0, 5, 2 ** 31, sref.TOP_KEY - 2])
    c = sref.first_candidates(key, 16)
    assert c.shape == (4, 16)
    assert bool((c[:, 1:] >= c[:, :-1]).all())
    assert bool((c >= 0).all()) and bool((c <= sref.TOP_KEY).all())
    assert torch.equal(c[:, 7], (key - 1).clamp_min(0))   # key - 1, then key
    assert torch.equal(c[:, 8], key)
    assert int(c[2, 0]) == 2 ** 31 - 4 ** 7 and int(c[2, 15]) == 2 ** 31 \
        + 4 ** 7 - 1


@pytest.mark.parametrize("s,v,want", [
    (1, 128256, 16), (7, 128256, 16), (8, 128256, 9), (9, 128256, 9),
    (10, 128256, 8), (64, 128256, 8), (8, 50304, 9), (1, 1000, 8),
    (1, 512, 4), (16, 200000, 9), (1, 256000, 16), (8, 256000, 16)])
def test_cluster_plan_fits_the_card_and_shared_memory(s, v, want):
    size = ops.cluster_plan(s, v)
    assert size == want
    assert ops.cluster_smem_bytes(v, size) <= ops.SMEM_BYTES
    assert size <= -(-v // sref.RED_TILE)       # no CTA without a tile


def test_cluster_plan_refuses_a_row_past_shared_memory():
    assert ops.MAX_ROW == 382976
    ops.cluster_plan(1, ops.MAX_ROW)
    with pytest.raises(ValueError, match="at most 382976"):
        ops.cluster_plan(8, ops.MAX_ROW + 128)
    with pytest.raises(ValueError, match="at most 382976"):
        ops.cluster_plan(1, 400000)
    # keys and masses of ceil(1002 / 16) tiles of 132 words and 16 sweep
    # partials a tile, then rank 0's receive buffer for the other 15 ranks'
    # tiles' partials
    assert ops.cluster_smem_bytes(128256, 16) == 4 * (63 * (2 * 132 + 16)
                                                      + 15 * 63 * 16)
    # 256,000 entries: 10 of the other 15 ranks fit, so two rounds
    assert ops.cluster_smem_bytes(256000, 16) == 4 * (125 * (2 * 132 + 16)
                                                      + 10 * 125 * 16)
    assert ops.sweep_rounds(256000, 16) == 2


def test_cluster_layout_constants_match_the_device_header():
    """The plan's shared-memory formula reads the device header's layout:
    its constants must be the header's."""
    from pathlib import Path
    text = (Path(ops.__file__).parent / "csrc" /
            "sampling_device.cuh").read_text()

    def const(name):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        return eval(line.split("=", 1)[1].split(";")[0])
    assert const("kSmemBytes") == ops.SMEM_BYTES
    assert const("kCand") == sref.CANDIDATES
    assert const("kTile") == ops.TILE
    assert const("kMaxCluster") == ops.MAX_CLUSTER
    assert "kStride = kTile + 4;" in text and ops.STRIDE == ops.TILE + 4


@pytest.mark.parametrize("v", [128256, 50304, 151936, 102400, 92544,
                               65536, 51968, 32768])
def test_served_rows_take_their_sweep_in_one_round(v):
    """At every vocabulary the port serves (8 slots), rank 0 receives every
    other rank's sweep partials at once: one cluster barrier before the
    fold, as before rows could outgrow it."""
    for s in range(1, 9):
        assert ops.sweep_rounds(v, ops.cluster_plan(s, v)) == 1


@pytest.mark.parametrize("s", [1, 8, 16, 64])
def test_cluster_plan_takes_command_r_rows(s):
    """command-r-35b's 256,000-entry rows fit at every row count up to 64
    (each rank stages the sweep partials of its own tiles)."""
    sizes = {ops.cluster_plan(n, 256000) for n in range(1, 65)}
    assert all(ops.cluster_smem_bytes(256000, z) <= ops.SMEM_BYTES
               for z in sizes)
    size = ops.cluster_plan(s, 256000)
    assert size <= ops.MAX_CLUSTER
    assert ops.cluster_smem_bytes(256000, size) <= ops.SMEM_BYTES


@pytest.mark.gpu
@pytest.mark.parametrize("v", [128256, 50304, 1000])
def test_filter_kernel_bitwise_matches_plain_on_card(v):
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    lg, top_k, top_p = _rows(6, 8, v)
    cases = [(lg, top_k, top_p), (lg[:4], top_k[:4], top_p[:4]),
             (lg[2:3], top_k[2:3], top_p[2:3])]
    rows = [adversarial_row(kind, v, seed) for seed, kind
            in enumerate(ADVERSARIAL)]
    cases.append(tuple(np.concatenate(c) for c in zip(*rows)))
    for case in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in case]
        n = ops.LAUNCHES["filter_logits"]
        out = ops.filter_logits(*args)
        assert ops.LAUNCHES["filter_logits"] == n + 1
        plain = sref.filter_logits_bisect(*args)
        assert torch.equal(out.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("v", [128256, 1000])
def test_draw_kernel_bitwise_matches_plain_on_card(v):
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    lg, top_k, top_p = _rows(9, 8, v)
    args = [torch.from_numpy(a).cuda() for a in (lg, top_k, top_p)]
    lg_f = sref.filter_logits_bisect(*args)
    rng = np.random.default_rng(9)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, 8)).cuda()
    pos = torch.from_numpy(rng.integers(0, 2 ** 31, 8).astype(np.int32)).cuda()
    for lg_case in (lg_f, torch.from_numpy(lg).cuda()):
        n = ops.LAUNCHES["draw_tokens"]
        out = ops.draw_tokens(lg_case, seeds, pos)
        assert ops.LAUNCHES["draw_tokens"] == n + 1
        assert torch.equal(out, head.draw_tokens(
            lg_case, head.row_uniforms(seeds, pos)))


@pytest.mark.gpu
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_device_uniforms_bitwise_match_plain_on_card(pos_dtype):
    """The draw kernels' device function against ``row_uniforms`` over
    65,536 (seed, position) pairs, 0 and 2^32 - 1 among both."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    rng = np.random.default_rng(12)
    seeds = rng.integers(0, 2 ** 32, 65536)
    pos = rng.integers(0, 2 ** 32, 65536)
    seeds[:2], pos[:4] = [0, 2 ** 32 - 1], [0, 2 ** 32 - 1, 0, 2 ** 32 - 1]
    seeds[2:4] = [0, 2 ** 32 - 1]
    pos_t = torch.from_numpy(pos).cuda()
    if pos_dtype == torch.int32:
        pos_t = pos_t.to(torch.int32)     # wraps: the low 32 bits
    seeds_t = torch.from_numpy(seeds).cuda()
    got = ops.device_row_uniforms(seeds_t, pos_t)
    want = head.row_uniforms(seeds_t, pos_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
