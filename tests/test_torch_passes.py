"""The port's isolation-pass path against the JAX package.

Documents with group opacity, masks, nested / anti-aliased / bbox-units
clips, lone blurs and multi-primitive filter chains: the port's lowering
must be bit-identical to the JAX package's (groups and blur-chunk tensors
included); the port's plain executors (the CPU path of every kernel
wrapper) must match JAX execute_lowered under SVGR_FUSED=0 (its XLA
executor) and SVGR_FUSED=interp (its Pallas kernels in interpret mode)
within 1e-5; the CLI PNG must stay within 1/255 of the JAX CLI's.  The
blur-chunk kernel's band tables and level packing are held to the chunks
they come from: the band walk adds the dense walk's terms bit for bit, and
a packed level writes the pool rows the per-chunk loop writes.  The
kernels themselves run only on a CUDA card, where chip_smoke.py holds them
against these plain versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgrasterize_tpu.render_plan as jrp
from svgrasterize_tpu.core.png import read_png
from svgrasterize_tpu.utils.stress import stress_doc as j_stress_doc

import svgrasterize_tpu_torch.render_plan as trp
from svgrasterize_tpu_torch.cli import main as torch_main
from svgrasterize_tpu_torch.core.transform import Transform as TTransform
from svgrasterize_tpu_torch.ops import batch_exec, filter_batch, fused_exec
from svgrasterize_tpu_torch.utils.stress import stress_doc

from test_filter_batch import BLURS
from torch_support import (PASS_DOCS, PASSES, assert_items_equal, assert_png_close, jax_lower,
                           jax_png, jax_scene, torch_lower, torch_scene, viewport_of)

# The bound tests/test_fused_exec.py holds between the JAX package's own
# two executors.
EXEC_TOL = 1e-5


def test_stress_doc_is_the_jax_packages():
    assert stress_doc(200, 256) == j_stress_doc(200, 256)
    assert stress_doc(37, 128, seed=5) == j_stress_doc(37, 128, seed=5)


def _assert_lowered_equal(ref, got):
    assert_items_equal(ref.items, got.items)
    assert tuple(got.grid) == tuple(ref.grid) and got.tile == ref.tile
    for a, b in zip(ref.bigs, got.bigs, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got.clips, ref.clips)
    assert np.array_equal(got.hull.raw_points, ref.hull.raw_points)
    assert len(got.groups) == len(ref.groups)
    for ga, gb in zip(ref.groups, got.groups):
        assert_items_equal(ga["items"], gb["items"])
        for a, b in zip(ga["bigs"], gb["bigs"], strict=True):
            assert np.array_equal(a, b)
        assert np.array_equal(ga["clips"], gb["clips"])
        for key in ("rows", "pool_lo", "pool_n", "needs_pool"):
            assert ga[key] == gb[key], key
        assert len(ga["parts"]) == len(gb["parts"])
        for pa, pb in zip(ga["parts"], gb["parts"]):
            for key in ("row_start", "n_rows", "src_tiles", "out_tiles", "pool_base"):
                assert pa[key] == pb[key], key
            assert (pa["post"] is None) == (pb["post"] is None)
            if pa["post"] is not None:
                assert pa["post"][2] == pb["post"][2]  # content bbox
        chunks_a, batched_a = ga["_blur_batch"]
        chunks_b, batched_b = gb["_blur_batch"]
        assert batched_a == batched_b
        assert len(chunks_a) == len(chunks_b)
        for ca, cb in zip(chunks_a, chunks_b):
            for key in ("B", "NSi", "NSj", "NOi", "NOj", "chain_linear", "pool_idx"):
                assert ca[key] == cb[key], key
            for key in ("lut", "bh", "bw", "out_idx", "src_alpha"):
                assert ca[key].dtype == cb[key].dtype, key
                assert np.array_equal(ca[key], cb[key]), key


@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(PASS_DOCS))
def test_pass_lowering_bit_identical(name, tile):
    ref = jax_lower(PASS_DOCS[name], tile)
    got = torch_lower(PASS_DOCS[name], tile)
    assert ref is not None and got is not None
    assert ref.groups, "the document must lower to isolation passes"
    _assert_lowered_equal(ref, got)


def test_passes_document_reaches_every_construct():
    lowered = torch_lower(PASSES, 32)
    assert len(lowered.groups) >= 2  # a filter nested in an opacity group
    assert any(g["needs_pool"] for g in lowered.groups)
    items = lowered.items
    assert (items["tex_idx"] >= 0).any() and (items["mask_idx"] >= 0).any()
    chunks = [ck for g in lowered.groups for ck in g["_blur_batch"][0]]
    assert chunks and any(ck["src_alpha"].any() for ck in chunks)
    posts = [p for g in lowered.groups for i, p in enumerate(g["parts"])
             if p["post"] is not None and i not in g["_blur_batch"][1]]
    assert len(posts) >= 2  # the drop shadow and the colour-matrix chain


def _jax_tiles(svg, tile, mode, monkeypatch):
    monkeypatch.setenv("SVGR_FUSED", mode)
    lowered = jax_lower(svg, tile)  # a fresh plan: JAX caches per plan
    return np.asarray(jrp.execute_lowered(lowered, (0, 0), False))


EXEC_CASES = [(name, "0") for name in sorted(PASS_DOCS)] + [
    ("passes", "interp"), ("masks", "interp"), ("blurs", "interp"),
    ("stress", "interp"),
]


@pytest.mark.parametrize("name,mode", EXEC_CASES)
def test_execute_lowered_matches_jax(name, mode, monkeypatch):
    ref = _jax_tiles(PASS_DOCS[name], 32, mode, monkeypatch)
    got = trp.execute_lowered(torch_lower(PASS_DOCS[name], 32), "cpu").numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= EXEC_TOL


@pytest.mark.parametrize("name", ["passes", "blurs"])
def test_execute_lowered_at_tile_128_matches_jax(name, monkeypatch):
    """Tile 128 end to end: the port's lowering, its pass levels (blur
    levels and pool rows at T=128) and executors against the JAX package's
    XLA executor on its own plan."""
    ref = _jax_tiles(PASS_DOCS[name], 128, "0", monkeypatch)
    got = trp.execute_lowered(torch_lower(PASS_DOCS[name], 128), "cpu").numpy()
    assert got.shape == ref.shape and got.shape[1] == 128 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= EXEC_TOL


@pytest.mark.parametrize("name", ["masks", "blurs", "stress"])
def test_port_executes_the_jax_plan(name, monkeypatch):
    """The port's upload and executors on the plan the JAX package lowered
    (groups and blur chunks included; these documents have no per-part
    filter chain, whose Filter objects are the JAX package's)."""
    monkeypatch.setenv("SVGR_FUSED", "0")
    lowered = jax_lower(PASS_DOCS[name], 32)
    ref = np.asarray(jrp.execute_lowered(lowered, (0, 0), False))
    got = trp.execute_lowered(lowered, "cpu").numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL


@pytest.mark.parametrize("linear", [False, True], ids=["srgb", "linear"])
def test_linear_rgb_canvas_matches_jax(linear, monkeypatch):
    monkeypatch.setenv("SVGR_FUSED", "0")
    jtr = jrp.Transform().matrix(0, 1, 0, 1, 0, 0)
    vp = viewport_of(BLURS)
    ref = np.asarray(jrp.execute_lowered(
        jrp.lower_scene(jax_scene(BLURS), jtr, vp, linear, tile=32), (0, 0), linear))
    low = trp.lower_scene(torch_scene(BLURS), TTransform().matrix(0, 1, 0, 1, 0, 0),
                          vp, linear, 32)
    got = trp.execute_lowered(low, "cpu", (0, 0), linear).numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL


def test_compiled_scene_serves_passes():
    """compile_scene uploads once and re-runs the levels per frame through
    the kernel wrappers; every frame equals a fresh execute_lowered and the
    plain-version run of the same program."""
    scene = torch_scene(PASSES)
    tr = TTransform().matrix(0, 1, 0, 1, 0, 0)
    vp = viewport_of(PASSES)
    cs = trp.compile_scene(scene, tr, vp, tile=32, device="cpu")
    fused_exec.reset_launch_counts()
    first = cs.render_tiles()
    second = cs.render_tiles()
    assert torch.equal(first, second)
    # on the CPU the wrappers take the plain versions: no kernel launches
    assert all(k.launches == 0 for k in fused_exec.KERNELS)
    ref = trp.execute_lowered(trp.lower_scene(scene, tr, vp, False, 32), "cpu")
    assert torch.equal(first, ref)
    assert torch.equal(cs.render_tiles(plain=True), first)
    layer = cs.render()
    assert tuple(layer.image.shape) == (vp[2], vp[3], 4)


def test_pool_rows_plain_matches_pallas_writer(monkeypatch):
    """The plain pool writer leaves the pool the JAX package's aliased
    Pallas row writer leaves (interpret mode): exactly."""
    _pool_rows_against_pallas(16, monkeypatch)


def test_pool_rows_plain_matches_pallas_writer_at_tile_128(monkeypatch):
    _pool_rows_against_pallas(128, monkeypatch)


def _pool_rows_against_pallas(t: int, monkeypatch):
    monkeypatch.setenv("SVGR_FUSED", "interp")
    rng = np.random.default_rng(3)
    cap, n, lo = 24, 7, 9
    pool = rng.random((cap, t, t, 4), dtype=np.float32)
    rows = rng.random((n, t, t, 4), dtype=np.float32)

    def planar(a):
        return a.transpose(0, 1, 3, 2).reshape(a.shape[0], t, 4 * t)

    ref = np.asarray(jrp._pool_update_aliased(
        jnp.asarray(planar(pool)), jnp.asarray(planar(rows)), lo, t))
    got = torch.from_numpy(pool.copy())
    src_idx = torch.arange(n, dtype=torch.int32)
    out = fused_exec.pool_rows(got, torch.from_numpy(rows), src_idx, src_idx + lo)
    assert out is got
    assert np.array_equal(planar(got.numpy()), ref)
    # a permuted gather-scatter, as a blur chunk's out tiles land
    perm = torch.tensor([3, 0, 6], dtype=torch.int32)
    dst = torch.tensor([1, 20, 5], dtype=torch.int32)
    batch_exec._pool_rows(got, torch.from_numpy(rows), perm, dst)
    assert np.array_equal(got.numpy()[[1, 20, 5]], rows[[3, 0, 6]])


@pytest.mark.parametrize("name", ["passes", "blurs"])
def test_cli_png_matches_jax_cli(name, tmp_path, monkeypatch):
    svg = tmp_path / "doc.svg"
    svg.write_text(PASS_DOCS[name])
    ref = jax_png(str(svg), str(tmp_path / "jax.png"), monkeypatch)
    assert torch_main([str(svg), str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    with open(tmp_path / "port.png", "rb") as f:
        assert_png_close(read_png(f.read()), ref)


def _clip_builder():
    return trp._Builder((0, 0, 64, 64), False, 16)


def _clip_scene(r: float):
    return torch_scene(
        "<svg xmlns='http://www.w3.org/2000/svg' width='64' height='64'>"
        f"<circle cx='30' cy='30' r='{r}'/></svg>"
    )


def test_clip_cache_keys_by_content():
    """Content-equal clip scenes built as separate objects share one cache
    entry; clips that differ in shape or transform do not."""
    tr = TTransform().matrix(0, 1, 0, 1, 0, 0)
    a, b, c = _clip_scene(20), _clip_scene(20), _clip_scene(21)
    assert a is not b
    builder = _clip_builder()
    clips = [trp._Clip(s, t, trp._clip_key(s, t))
             for s, t in ((a, tr), (b, tr), (c, tr), (a, tr.translate(1, 0)))]
    assert clips[0].key == clips[1].key
    assert len({clip.key for clip in clips}) == 3
    fields = [builder._clip_tile(clip, 0, 1) for clip in clips]  # on the edge
    assert len(builder.clip_flat_cache) == 3
    assert isinstance(fields[0], np.ndarray) and fields[0] is fields[1]
    assert not np.array_equal(fields[0], fields[2])


_FE_IMAGE = """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
<defs><g id='frag'><circle cx='12' cy='12' r='10' fill='lime'/></g>
<filter id='f'><feImage href='#frag' result='im'/>
<feComposite in='im' in2='SourceGraphic' operator='over'/></filter></defs>
<rect x='24' y='8' width='30' height='30' fill='blue' filter='url(#f)'/></svg>"""

_PATTERN_IN_GROUP = """<svg xmlns='http://www.w3.org/2000/svg' width='64' height='48'>
<defs><pattern id='p' width='8' height='8' patternUnits='userSpaceOnUse'>
<rect width='4' height='4' fill='#d04020'/></pattern></defs>
<g opacity='0.5'><rect x='4' y='4' width='50' height='30' fill='url(#p)'/>
<circle cx='30' cy='24' r='12' fill='blue'/></g></svg>"""


@pytest.mark.parametrize("svg", [_FE_IMAGE, _PATTERN_IN_GROUP], ids=["fe_image", "pattern"])
def test_interpreter_features_still_raise(svg, tmp_path, monkeypatch):
    """feImage and a pattern inside an opacity group lower to isolation
    passes as in the JAX package: render_fast's tiles match its XLA
    executor and the CLI PNG its CLI.  (The name is the one this test had
    while both raised.)"""
    monkeypatch.setenv("SVGR_FUSED", "0")
    ref = np.asarray(jrp.execute_lowered(jax_lower(svg, 32), (0, 0), False))
    lowered = torch_lower(svg, 32)
    assert lowered.groups
    got = trp.execute_lowered(lowered, "cpu").numpy()
    assert np.abs(got - ref).max() <= EXEC_TOL
    path = tmp_path / "doc.svg"
    path.write_text(svg)
    png = jax_png(str(path), str(tmp_path / "jax.png"), monkeypatch)
    assert torch_main([str(path), str(tmp_path / "out.png"), "--device", "cpu"]) == 0
    with open(tmp_path / "out.png", "rb") as f:
        assert_png_close(read_png(f.read()), png)


# documents whose passes batch blur chunks at every tile size
CHUNK_DOCS = ["blurs", "filter_blur_offset", "mixed", "passes"]


def _doc_chunks(name, tile):
    chunks = [ck for g in torch_lower(PASS_DOCS[name], tile).groups for ck in g["_blur_batch"][0]]
    assert chunks
    return chunks


def _random_chunks(rng, tile, rows):
    """Random chunks over canvas rows [0, rows): parts whose crops and
    placements differ (a small crop leaves out tiles with empty bands, as a
    chunk's smaller parts do), -1 span tiles, both colorspaces."""
    chunks = []
    for _ in range(3):
        B = int(rng.integers(1, 4))
        nsi, nsj = (int(v) for v in rng.integers(1, 4, 2))
        noi, noj = nsi + int(rng.integers(0, 2)), nsj + int(rng.integers(0, 2))

        def band(taps, n_in, n_out):
            crop = int(rng.integers(1, n_in + 1))
            return filter_batch._band(taps, crop, int(rng.integers(0, n_in - crop + 1)),
                                      int(rng.integers(-len(taps), tile)), n_out, n_in)

        u = rng.random(int(rng.integers(1, 12)) | 1)
        v = rng.random(int(rng.integers(1, 12)) | 1)
        n_out = B * noi * noj
        out_idx = np.sort(rng.permutation(n_out)[: n_out // 2 + 1]).astype(np.int32)
        chunks.append({
            "B": B, "NSi": nsi, "NSj": nsj, "NOi": noi, "NOj": noj,
            "chain_linear": bool(rng.integers(0, 2)),
            "lut": rng.integers(-1, rows, (B, nsi * nsj)).astype(np.int32),
            "bh": np.stack([band(u / u.sum(), nsi * tile, noi * tile) for _ in range(B)]),
            "bw": np.stack([band(v / v.sum(), nsj * tile, noj * tile) for _ in range(B)]),
            "src_alpha": rng.random(B) < 0.5,
            "out_idx": out_idx,
        })
    # each pool row written once per level, as lowering numbers them
    rows_of = np.split(rng.permutation(64), np.cumsum([len(ck["out_idx"]) for ck in chunks]))
    for ck, pool_rows in zip(chunks, rows_of):
        ck["pool_idx"] = [int(x) for x in pool_rows]
    return chunks


def _steps(lo, hi, step):
    """The columns of a band's walk: its step-aligned steps, whole."""
    if lo >= hi:
        return np.zeros(0, np.int64)
    return np.arange(lo // step * step, -(-hi // step) * step)


def _fma(a, b, c):
    """f32 fused multiply-adds a * b + c, emulated in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _walk(bh_rows, x, bw_rows, hs, ws):
    """The kernel's sums for one block, one fused multiply-add at a time:
    Z[r, w] over h in hs, then out[r, q] over w in ws."""
    out = np.zeros((bh_rows.shape[0], bw_rows.shape[0]), np.float32)
    if not len(hs) or not len(ws):
        return out
    z = np.zeros((bh_rows.shape[0], len(ws)), np.float32)
    for h in hs:
        z = _fma(bh_rows[:, h, None], x[h, ws][None], z)
    for k, w in enumerate(ws):
        out = _fma(z[:, k, None], bw_rows[None, :, w], out)
    return out


def _assert_bands(ck, tile, rng, walks: int):
    """The band tables of a chunk cover every nonzero of its operators, an
    empty band means an all-zero slice, and the band walk of `walks` kernel
    blocks (16 out rows of one out tile) equals the dense walk bit for
    bit."""
    rows = filter_batch.BLUR_ROWS
    hband, wband = filter_batch.band_tables(ck, tile)
    B, nsi, nsj, noi, noj = (ck[k] for k in ("B", "NSi", "NSj", "NOi", "NOj"))
    bh = np.asarray(ck["bh"], np.float32)
    bw = np.asarray(ck["bw"], np.float32)
    assert hband.shape == (B * noi * tile // rows, 2) and wband.shape == (B * noj, 2)
    for m, bands, n in ((bh, hband, rows), (bw, wband, tile)):
        for (lo, hi), block in zip(bands, m.reshape(len(bands), n, -1), strict=True):
            nz = np.flatnonzero(block.any(axis=0))
            if lo >= hi:
                assert nz.size == 0 and lo == hi == 0
            else:
                assert nz[0] == lo and nz[-1] == hi - 1
    step = filter_batch.BLUR_STEP[tile]
    H, W = nsi * tile, nsj * tile
    blocks = [(b, r, oj) for b in range(B) for r in range(noi * tile // rows)
              for oj in range(noj)]
    for k in rng.permutation(len(blocks))[:walks]:
        b, r, oj = blocks[k]
        x = rng.random((H, W), dtype=np.float32)
        bh_rows = bh[b, r * rows:(r + 1) * rows]
        bw_rows = bw[b, oj * tile:(oj + 1) * tile]
        dense = _walk(bh_rows, x, bw_rows, np.arange(H), np.arange(W))
        banded = _walk(bh_rows, x, bw_rows, _steps(*hband[b * noi * tile // rows + r], step),
                       _steps(*wband[b * noj + oj], step))
        assert np.array_equal(dense.view(np.uint32), banded.view(np.uint32))


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
@pytest.mark.parametrize("name", CHUNK_DOCS)
def test_blur_band_tables_on_document_chunks(name, tile):
    rng = np.random.default_rng(tile)
    for ck in _doc_chunks(name, tile):
        _assert_bands(ck, tile, rng, walks=3)


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_blur_band_tables_on_random_chunks(tile):
    rng = np.random.default_rng(40 + tile)
    chunks = _random_chunks(rng, tile, 8)
    assert any(lo >= hi for ck in chunks for lo, hi in filter_batch.band_tables(ck, tile)[0])
    for ck in chunks:
        _assert_bands(ck, tile, rng, walks=4)


def _assert_packed(level, chunks, tile):
    """What the kernel reads through the packed level's table (its chunks
    in level.order): for every out tile, found by binary search over the
    chunks' first out tiles, the
    lut row, BH and BW rows, SourceAlpha flag and bands at the table's
    offsets are its chunk's own; out_idx / pool_idx are the chunks',
    concatenated with each chunk's first out tile added."""
    from svgrasterize_tpu_torch.ops.filter_batch import (
        LT_B, LT_BH, LT_BW, LT_HB, LT_LINEAR, LT_LUT, LT_NOI, LT_NOJ, LT_NSI, LT_NSJ,
        LT_OUT, LT_PART, LT_WB)

    assert sorted(level.order) == list(range(len(chunks)))
    chunks = [chunks[i] for i in level.order]
    table = level.table.numpy()
    lut, bh, bw = level.lut.numpy(), level.bh.numpy(), level.bw.numpy()
    assert level.tiles == sum(ck["B"] * ck["NOi"] * ck["NOj"] for ck in chunks)
    for tile_i in range(level.tiles):
        c = int(np.searchsorted(table[:, LT_OUT], tile_i, side="right")) - 1
        row, ck = table[c], chunks[c]
        nsi, nsj, noi, noj = (int(v) for v in row[[LT_NSI, LT_NSJ, LT_NOI, LT_NOJ]])
        assert (row[LT_B], nsi, nsj, noi, noj) == tuple(
            ck[k] for k in ("B", "NSi", "NSj", "NOi", "NOj"))
        assert row[LT_LINEAR] == int(ck["chain_linear"])
        local = tile_i - row[LT_OUT]
        b, oi, oj = local // (noi * noj), local % (noi * noj) // noj, local % noj
        H, W = nsi * tile, nsj * tile
        at = row[LT_LUT] + b * nsi * nsj
        assert np.array_equal(lut[at:at + nsi * nsj], np.asarray(ck["lut"])[b])
        at = row[LT_BH] + (b * noi * tile + oi * tile) * H
        assert np.array_equal(bh[at:at + tile * H].reshape(tile, H),
                              np.asarray(ck["bh"])[b, oi * tile:(oi + 1) * tile])
        at = row[LT_BW] + (b * noj * tile + oj * tile) * W
        assert np.array_equal(bw[at:at + tile * W].reshape(tile, W),
                              np.asarray(ck["bw"])[b, oj * tile:(oj + 1) * tile])
        assert level.src_alpha[row[LT_PART] + b] == int(np.asarray(ck["src_alpha"])[b])
        hband, wband = filter_batch.band_tables(ck, tile)
        split = tile // filter_batch.BLUR_ROWS
        at = (b * noi + oi) * split
        assert (level.hband[row[LT_HB] + at:row[LT_HB] + at + split].tolist()
                == hband[at:at + split].tolist())
        assert level.wband[row[LT_WB] + b * noj + oj].tolist() == wband[b * noj + oj].tolist()
    firsts = table[:, LT_OUT]
    assert level.out_idx.tolist() == [int(i) + int(f) for ck, f in zip(chunks, firsts)
                                      for i in ck["out_idx"]]
    assert level.pool_idx.tolist() == [int(p) for ck in chunks for p in ck["pool_idx"]]


def _pools(canvas, level, t, linear_rgb, pool_rows):
    """The pool rows of the per-chunk loop and of the packed level (one
    plain apply_level, one pool write)."""
    loop = torch.zeros((pool_rows, t, t, 4))
    for ck in level.chunks:
        batch_exec._pool_rows(loop, filter_batch.apply_chunk(canvas, ck, t, linear_rgb),
                              ck["out_idx"], ck["pool_idx"])
    packed = torch.zeros((pool_rows, t, t, 4))
    batch_exec._pool_rows(packed, filter_batch.apply_level(canvas, level, t, linear_rgb),
                          level.out_idx, level.pool_idx)
    return loop, packed


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_level_packing_of_random_chunks(tile):
    rng = np.random.default_rng(60 + tile)
    chunks = _random_chunks(rng, tile, 8)
    level = filter_batch.pack_level(chunks, tile, "cpu")
    _assert_packed(level, chunks, tile)
    canvas = torch.from_numpy(rng.random((8, tile, tile, 4), dtype=np.float32))
    canvas[..., :3] *= canvas[..., 3:]
    for linear_rgb in (False, True):
        loop, packed = _pools(canvas, level, tile, linear_rgb, 64)
        assert torch.equal(loop, packed) and float(packed.abs().max()) > 0.0
    # the wrapper takes the plain level for CPU tensors: no launch
    fused_exec.reset_launch_counts()
    assert torch.equal(fused_exec.blur_chunk(canvas, level, tile, False),
                       filter_batch.apply_level(canvas, level, tile, False))
    assert fused_exec.blur_chunk.launches == 0
    assert filter_batch.pack_level([], tile, "cpu") is None


@pytest.mark.parametrize("name", CHUNK_DOCS)
def test_level_packing_of_document_levels(name):
    """Each level of the uploaded program packs its chunks as lowering
    built them, and writes the per-chunk loop's pool rows."""
    lowered = torch_lower(PASS_DOCS[name], 32)
    prog = trp.upload_program(lowered, "cpu")
    rng = np.random.default_rng(7)
    packed_levels = 0
    for g, level in zip(lowered.groups, prog.levels):
        chunks = g["_blur_batch"][0]
        assert (level.blur is None) == (not chunks)
        if level.blur is None:
            continue
        packed_levels += 1
        _assert_packed(level.blur, chunks, 32)
        canvas = torch.from_numpy(rng.random((g["rows"], 32, 32, 4), dtype=np.float32))
        canvas[..., :3] *= canvas[..., 3:]
        loop, packed = _pools(canvas, level.blur, 32, False, prog.pool_rows)
        assert torch.equal(loop, packed)
    assert packed_levels
