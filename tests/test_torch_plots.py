"""The port's evaluation plots against the JAX package's (matplotlib, cv2).

1. ``utils/raster``'s ``line_aa`` / ``circle_aa`` equal ``cv2.line(...,
   LINE_AA)`` of thickness 2-6 and ``cv2.circle(..., -1, LINE_AA)`` of
   radius 0-20 pixel for pixel, over random shapes on random images,
   partly outside them.
2. ``plotResult``: the background (min-max normalization, the ND hack,
   GRAY2BGR, the nearest upsample) bit-equal to the JAX package's, and the
   annotated image equal to it (cv2's strokes) under 'nice', 'gray' and
   fixed colours at ``annoscale`` 1 and 2; ``name`` writes a PNG.
3. ``plotEvaluation``: the three PDFs are well formed (header, every xref
   offset at its ``n 0 obj``, ``%%EOF``), and each curve and bar read back
   from them equals exactly (float64) what the JAX call handed
   ``matplotlib.axes.Axes.plot`` / ``.bar`` (recorded by wrapping them),
   with the tick labels, ``ylim`` and legend entries.
4. ``plotResult3D``: the cloud, joints, bones and colours equal what JAX
   passes to ``Axes3D.scatter`` / ``.plot``; the joints' pixels equal
   matplotlib's (``ax.get_proj()`` and ``ax.transData`` of the JAX figure,
   caught by wrapping ``matplotlib.pyplot.close``) within 1 px after a
   per-axis scale and offset; ``filename`` writes a PNG the port's reader
   reads back.
"""

import re

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import Axes3D, proj3d  # noqa: E402

from lsps_tpu.data.camera import Camera as JCamera  # noqa: E402
from lsps_tpu.data.detector import HandDetector  # noqa: E402
from lsps_tpu.data.synthetic import render_hand_depth  # noqa: E402
from lsps_tpu.eval import handpose_evaluation as J  # noqa: E402
from lsps_tpu_torch.data.camera import Camera as PCamera  # noqa: E402
from lsps_tpu_torch.data.png import read_png  # noqa: E402
from lsps_tpu_torch.data.transformations import (  # noqa: E402
    transform_points_2d)
from lsps_tpu_torch.eval import handpose_evaluation as P  # noqa: E402
from lsps_tpu_torch.utils import pdf as PDF  # noqa: E402
from lsps_tpu_torch.utils import raster as R  # noqa: E402

cv2 = pytest.importorskip("cv2")

EVALS = {"nyu14": (J.NYUHandposeEvaluation, P.NYUHandposeEvaluation, 14),
         "nyu36": (J.NYUHandposeEvaluation, P.NYUHandposeEvaluation, 36),
         "icvl": (J.ICVLHandposeEvaluation, P.ICVLHandposeEvaluation, 16),
         "msra": (J.MSRAHandposeEvaluation, P.MSRAHandposeEvaluation, 21)}


# ---------------------------------------------------------------------------
# 1. the rasterizer against cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["line", "circle"])
def test_raster_shapes_are_cv2s(shape):
    rs = np.random.RandomState(5 if shape == "line" else 6)
    for t in range(150):
        img = rs.randint(0, 256, (80, 90, 3)).astype(np.uint8)
        color = tuple(int(c) for c in rs.randint(0, 256, 3))
        ref, got = img.copy(), img.copy()
        if shape == "line":
            p0 = (int(rs.randint(-15, 105)), int(rs.randint(-15, 95)))
            p1 = (int(rs.randint(-15, 105)), int(rs.randint(-15, 95)))
            th = int(rs.choice([2, 3, 4, 6]))
            cv2.line(ref, p0, p1, color, thickness=th,
                     lineType=cv2.LINE_AA)
            R.line_aa(got, p0, p1, color, th)
        else:
            c = (int(rs.randint(-15, 105)), int(rs.randint(-15, 95)))
            r = int(rs.choice([0, 1, 3, 6, 12, 20]))
            cv2.circle(ref, c, r, color, -1, cv2.LINE_AA)
            R.circle_aa(got, c, r, color)
        np.testing.assert_array_equal(got, ref, err_msg=f"{shape} {t}")


# ---------------------------------------------------------------------------
# 2. plotResult
# ---------------------------------------------------------------------------

def _scene(seed, nj):
    """A rendered NYU hand cropped by the JAX detector: the metric crop
    (background 0), its transform, the 3D joints and a noisy prediction,
    and both in crop pixels."""
    rs = np.random.RandomState(seed)
    cam = JCamera.nyu()
    com = np.array([20.0 - 10 * seed, -10.0, 650.0 + 30 * seed], np.float32)
    dpt, j3d = render_hand_depth(cam, com, nj, rs)[:2]
    hd = HandDetector(dpt, cam.fx, cam.fy)
    crop, M, _ = hd.crop_area_3d(cam.to_img(com[None])[0], (250, 250, 250))
    crop = np.where(crop > 0, crop, 0).astype(np.float32)
    pred = (j3d + rs.randn(nj, 3) * 6).astype(np.float32)
    return (crop, M, j3d, pred, transform_points_2d(cam.to_img(j3d), M),
            transform_points_2d(cam.to_img(pred), M))


@pytest.mark.parametrize("upsample", [4.0, 2.5, 1.0])
def test_plot_result_background_is_jaxs(upsample):
    rs = np.random.RandomState(0)
    crops = [_scene(0, 14)[0],
             (rs.rand(40, 30) * 300 + 500).astype(np.float32),
             np.zeros((16, 16), np.float32),
             np.full((8, 8), 700.0, np.float32)]
    jev, pev = (J.NYUHandposeEvaluation(np.zeros((1, 14, 3)),
                                        np.zeros((1, 14, 3))),
                P.NYUHandposeEvaluation(np.zeros((1, 14, 3)),
                                        np.zeros((1, 14, 3))))
    for i, d in enumerate(crops):
        for show_depth in (True, False):
            want = jev.plotResult(d, None, None, upsample=upsample,
                                  showDepth=show_depth)
            got = pev.plotResult(d, None, None, upsample=upsample,
                                 showDepth=show_depth)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"crop {i}")


@pytest.mark.parametrize("annoscale", [1, 2])
@pytest.mark.parametrize("kind", sorted(EVALS))
def test_plot_result_strokes_are_cv2s(kind, annoscale, tmp_path):
    jcls, pcls, nj = EVALS[kind]
    crop, _, j3d, pred, gt2, pr2 = _scene(1, nj)
    jev, pev = jcls(j3d[None], pred[None]), pcls(j3d[None], pred[None])
    bg = pev.plotResult(crop, None, None, annoscale=annoscale)
    for nice in (False, True):
        want = jev.plotResult(crop, gt2, pr2, annoscale=annoscale,
                              niceColors=nice)
        got = pev.plotResult(crop, gt2, pr2, annoscale=annoscale,
                             niceColors=nice)
        drawn_p, drawn_j = (got != bg).any(-1), (want != bg).any(-1)
        assert drawn_j.sum() > 500
        overlap = (drawn_p & drawn_j).sum() / max(drawn_p.sum(),
                                                  drawn_j.sum())
        assert overlap >= 0.9, overlap
        same = (got == want).all(-1)
        assert same[drawn_p & drawn_j].mean() >= 0.9
        np.testing.assert_array_equal(got, want, err_msg=f"nice={nice}")
    # fixed colours and 'gray' straight through plotJoints
    for color, jcolor in (((10, 200, 30), None), ("gray", None),
                          ("nice", (5, 6, 7)), ("gray", "nice")):
        a = np.full((512, 512, 3), 128, np.uint8)
        b = a.copy()
        jev.plotJoints(a, gt2 * 4, color=color, jcolor=jcolor,
                       annoscale=annoscale)
        pev.plotJoints(b, gt2 * 4, color=color, jcolor=jcolor,
                       annoscale=annoscale)
        np.testing.assert_array_equal(b, a, err_msg=f"{color} {jcolor}")
    path = str(tmp_path / "r.png")
    assert pev.plotResult(crop, gt2, pr2, name=path) is None
    back = read_png(path)
    np.testing.assert_array_equal(back[..., ::-1], pev.plotResult(
        crop, gt2, pr2))


# ---------------------------------------------------------------------------
# 3. plotEvaluation
# ---------------------------------------------------------------------------

def _check_pdf_file(data: bytes):
    """Header, xref offsets at their objects, startxref, %%EOF."""
    assert data.startswith(b"%PDF-1.4")
    assert data.rstrip().endswith(b"%%EOF")
    start = int(data[data.rindex(b"startxref"):].split()[1])
    assert data[start:start + 4] == b"xref"
    rows = data[start:].split(b"\n")
    first, count = (int(v) for v in rows[1].split())
    for k in range(1, count):
        off, _, flag = rows[2 + k].split()
        assert flag == b"n"
        assert data[int(off):].startswith(f"{first + k} 0 obj".encode())
    assert PDF.check_pdf(data) == count - 1


def _content(data: bytes) -> str:
    m = re.search(rb"stream\n(.*?)endstream", data, re.S)
    return m.group(1).decode("latin-1")


def _data_block(content: str):
    """The data block's scales and its paths: [(kind, colour, numbers)]."""
    head, _, rest = content.partition("% data-scale ")
    line, _, rest = rest.partition("\n")
    sx, sy = (float(v) for v in line.split())
    block = rest.split("\nQ\n")[0]
    items = []
    for m in re.finditer(r"([\d. ]+) RG 1\.5 w \[\] 0 d 1 J 1 j\n(.*?)\nS",
                         block, re.S):
        pts = [tuple(float(v) for v in ln.split()[:2])
               for ln in m.group(2).split("\n")]
        items.append(("line", m.group(1), pts))
    for m in re.finditer(r"([\d. ]+) rg (\S+) (\S+) (\S+) (\S+) re f",
                         block):
        items.append(("bar", m.group(1),
                      tuple(float(m.group(k)) for k in range(2, 6))))
    return sx, sy, items


def _texts(content: str):
    return [m.group(1) for m in re.finditer(r"\((.*?)\) Tj", content)]


@pytest.mark.parametrize("kind", ["nyu14", "nyu36", "icvl"])
def test_plot_evaluation_draws_jaxs_values(kind, tmp_path, monkeypatch):
    jcls, pcls, nj = EVALS[kind]
    rs = np.random.RandomState(3)
    gt = rs.randn(25, nj, 3) * 40 + [0, 0, 700]
    pr = gt + rs.randn(25, nj, 3) * rs.uniform(2, 25, (1, nj, 1))
    pr2 = gt + rs.randn(25, nj, 3) * 15
    recorded = {"plot": [], "bar": []}
    real_plot, real_bar = matplotlib.axes.Axes.plot, matplotlib.axes.Axes.bar

    def plot(self, *a, **kw):
        recorded["plot"].append((a, kw))
        return real_plot(self, *a, **kw)

    def bar(self, *a, **kw):
        recorded["bar"].append((a, kw))
        return real_bar(self, *a, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", plot)
    monkeypatch.setattr(matplotlib.axes.Axes, "bar", bar)
    for side, cls, d in (("jax", jcls, tmp_path / "j"),
                         ("port", pcls, tmp_path / "p")):
        ev = cls(gt, pr)
        ev.subfolder = str(d)
        base = cls(gt, pr2)
        ev.plotEvaluation("run", baseline=[("baseline", base)])
    monkeypatch.undo()
    names = ["frameswithin", "joint_mean", "joint_max"]
    contents = {}
    for n in names:
        assert (tmp_path / "j" / f"run_{n}.pdf").exists()
        data = (tmp_path / "p" / f"run_{n}.pdf").read_bytes()
        _check_pdf_file(data)
        contents[n] = _content(data)

    # the curves: x = 0..79 implicit in the JAX call, y its list
    sx, sy, items = _data_block(contents["frameswithin"])
    lines = [pts for k, _, pts in items if k == "line"]
    assert len(lines) == len(recorded["plot"]) == 2
    for pts, (args, kw) in zip(lines, recorded["plot"]):
        want = [float(v) for v in args[0]]
        assert [x / sx for x, _ in pts] == [float(i) for i in
                                            range(len(want))]
        assert [y / sy for _, y in pts] == want
    texts = _texts(contents["frameswithin"])
    assert {"Our method", "baseline", "Distance threshold / mm"} <= set(texts)
    assert "100" in texts and "0" in texts        # ylim 0 to 100 ticked

    # the bars: heights exactly, centres to the last bits
    for n, calls in (("joint_mean", recorded["bar"][:2]),
                     ("joint_max", recorded["bar"][2:])):
        sx, sy, items = _data_block(contents[n])
        bars = [r for k, _, r in items if k == "bar"]
        want_h = [float(h) for args, kw in calls for h in args[1]]
        want_x = [float(x) for args, kw in calls for x in args[0]]
        assert [h / sy for _, _, _, h in bars] == want_h
        np.testing.assert_allclose([(x + w / 2) / sx for x, _, w, _ in bars],
                                   want_x, rtol=0, atol=1e-12)
        for args, kw in calls:
            assert kw["label"] in _texts(contents[n])
    ev = pcls(gt, pr)
    labels = list(ev.jointNames)[:nj]
    labels += [str(j) for j in range(len(labels), nj)]
    texts = _texts(contents["joint_mean"])
    assert [t for t in texts if t in set(labels + ["Avg"])][:nj + 1] == \
        labels + ["Avg"]
    assert "200" in _texts(contents["joint_max"])   # ylim 0 to 200


# ---------------------------------------------------------------------------
# 4. plotResult3D
# ---------------------------------------------------------------------------

def _record_3d(monkeypatch):
    """Wrap both packages' 3D calls and plt.close; returns the records."""
    rec = {"jax": [], "port": [], "figs": []}
    real_s, real_p = Axes3D.scatter, Axes3D.plot

    def jscatter(self, *a, **kw):
        rec["jax"].append(("scatter", a, kw))
        return real_s(self, *a, **kw)

    def jplot(self, *a, **kw):
        rec["jax"].append(("plot", a, kw))
        return real_p(self, *a, **kw)

    ps, pp = P.Scene3D.scatter, P.Scene3D.plot

    def pscatter(self, *a, **kw):
        rec["port"].append(("scatter", a, kw))
        return ps(self, *a, **kw)

    def pplot(self, *a, **kw):
        rec["port"].append(("plot", a, kw))
        return pp(self, *a, **kw)

    real_close = plt.close

    def close(fig=None):
        rec["figs"].append(fig)
        return real_close(fig)

    monkeypatch.setattr(Axes3D, "scatter", jscatter)
    monkeypatch.setattr(Axes3D, "plot", jplot)
    monkeypatch.setattr(P.Scene3D, "scatter", pscatter)
    monkeypatch.setattr(P.Scene3D, "plot", pplot)
    monkeypatch.setattr(plt, "close", close)
    return rec


def _same_call(a, b, what):
    assert a[0] == b[0], what
    assert len(a[1]) == len(b[1]), what
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)
    assert set(a[2]) == set(b[2]), what
    for k in a[2]:
        x, y = a[2][k], b[2][k]
        if isinstance(x, str) or isinstance(y, str):
            assert x == y, (what, k)
        else:
            np.testing.assert_array_equal(np.asarray(x, np.float64),
                                          np.asarray(y, np.float64),
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind,nice", [("nyu36", True), ("nyu14", False),
                                       ("icvl", True)])
def test_plot_result_3d_draws_what_jax_draws(kind, nice, monkeypatch,
                                             tmp_path):
    jcls, pcls, nj = EVALS[kind]
    crop, M, j3d, pred, _, _ = _scene(2, nj)
    jev, pev = jcls(j3d[None], pred[None]), pcls(j3d[None], pred[None])
    if kind == "nyu14":
        jev.jointColors = pev.jointColors = []   # no tables: plain colours
    rec = _record_3d(monkeypatch)
    scenes = []
    real_init = P.Scene3D.__init__

    def init(self):
        real_init(self)
        scenes.append(self)

    monkeypatch.setattr(P.Scene3D, "__init__", init)
    want = jev.plotResult3D(crop, M, j3d, pred, camera=JCamera.nyu(),
                            niceColors=nice)
    got = pev.plotResult3D(crop, M, j3d, pred, camera=PCamera.nyu(),
                           niceColors=nice)
    assert got.shape == (600, 600, 3) and got.dtype == np.uint8
    assert want.shape[2] == 3
    assert len(rec["jax"]) == len(rec["port"]) > 2
    assert rec["jax"][0][2]["c"] == "0.6"          # the cloud first
    assert len(rec["jax"][0][1][0]) > 100
    for i, (a, b) in enumerate(zip(rec["jax"], rec["port"])):
        _same_call(a, b, f"call {i}")
    # the joints' pixels: matplotlib's projection of the JAX figure
    fig = rec["figs"][-1]
    ax = fig.axes[0]
    xs, ys, _ = proj3d.proj_transform(pred[:, 0], pred[:, 1], pred[:, 2],
                                      ax.get_proj())
    disp = ax.transData.transform(np.stack([xs, ys], 1))
    want_px = np.stack([disp[:, 0], fig.bbox.height - disp[:, 1]], 1)
    got_px = scenes[-1].to_pixels(pred)[:, :2]
    for k in range(2):
        A = np.stack([got_px[:, k], np.ones(len(got_px))], 1)
        coef = np.linalg.lstsq(A, want_px[:, k], rcond=None)[0]
        assert np.abs(A @ coef - want_px[:, k]).max() <= 1.0, k
    # the limits are matplotlib's autoscaled ones
    np.testing.assert_allclose(scenes[-1].limits(), np.array(
        [ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()]), rtol=1e-12)
    # with a filename: the PNG, read back by the port's reader
    monkeypatch.undo()
    pev.subfolder = str(tmp_path)
    assert pev.plotResult3D(crop, M, j3d, pred, filename="_test3d",
                            camera=PCamera.nyu(), niceColors=nice) is None
    back = read_png(str(tmp_path / "_test3d.png"))
    np.testing.assert_array_equal(back, got)


def test_scene_draws_its_marks():
    s = P.Scene3D()
    s.scatter([0, 10], [0, 10], [0, 10], c=[(1, 0, 0), (0, 0, 1)],
              marker="s", s=25)
    s.plot([0, 10], [10, 0], [5, 5], color=(0, 1, 0), linewidth=3)
    s.set_xlabel("x / mm")
    s.view_init(-75, -90)
    img = s.render()
    px = np.rint(s.to_pixels(np.array([[0.0, 0, 0], [10, 10, 10]]))
                 ).astype(int)
    colours = {tuple(img[r, c]) for c, r, _ in px}
    assert colours == {(255, 0, 0), (0, 0, 255)}
    assert ((img == (0, 255, 0)).all(-1)).sum() > 50     # the bone
    assert ((img == 0).all(-1)).sum() > 20               # the label
    with pytest.raises(ValueError):
        R.text(img, 10, 10, "?", (0, 0, 0))
