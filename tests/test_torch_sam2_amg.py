"""SAM2's automatic mask generation in the port against vdn on the CPU:
connected components (the kernel's plain version against vdn's C++
union-find, bit for bit), the hole and sprinkle post-processing, each AMG
op of vdn_torch.ops.amg against vdn/ops/amg.py (exactly: RLE, stability,
boxes, grids, crops, small-region removal with the largest-island tie,
NMS at distinct scores and at the IoU threshold itself), and
Sam2AutomaticMaskGenerator against vdn's on the ``sam2_test`` trunk at
128 px (tests/test_torch_sam2.py's weights): the post-processing on vdn's
own logits gives vdn's records exactly, and the whole generator gives
vdn's records.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sam2 import D, SIZE, _np, seeded_tree

torch.set_num_threads(2)


def spiral(n: int) -> np.ndarray:
    """An n x n square spiral one pixel wide with one-pixel gaps: one
    component whose path is ~n^2 / 2 pixels long."""
    m = np.zeros((n, n), bool)
    y = x = 0
    dy, dx = 0, 1
    m[0, 0] = True
    while True:
        for _ in range(2):
            ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
            if (0 <= ny < n and 0 <= nx < n and not m[ny, nx]
                    and not (0 <= ay < n and 0 <= ax < n and m[ay, ax])):
                y, x = ny, nx
                m[y, x] = True
                break
            dy, dx = dx, -dy
        else:
            return m


def _cc_mask(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case.startswith("p"):
        return rng.random((6, 96, 130)) < float(case[1:])
    if case == "spiral":
        return spiral(160)[None]
    if case == "empty":
        return np.zeros((2, 40, 50), bool)
    if case == "full":
        return np.ones((2, 40, 50), bool)
    if case == "nchw":
        return rng.random((3, 1, 64, 70)) < 0.5
    # uint8 values other than 1 count as foreground, as the C++ reads them
    return (rng.integers(0, 4, (2, 50, 60)) * (rng.random((2, 50, 60))
                                               < 0.5)).astype(np.uint8)


@pytest.mark.parametrize("case", ["p0.41", "p0.6", "spiral", "empty",
                                  "full", "nchw", "uint8"])
def test_connected_components_match_vdn(case):
    """The plain version (hook and jump) against vdn's get_connected_
    components (the C++ union-find): labels and areas bit-equal, int32,
    random masks near and above the 8-neighbour percolation threshold, a
    spiral, empty and full masks, [N, 1, H, W] and uint8 values."""
    from vdn.ops.connected_components import get_connected_components as J
    from vdn_torch.ops.connected_components import \
        get_connected_components as T
    mask = _cc_mask(case)
    want = J(mask)
    got = T(torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    if case == "spiral":
        assert int(got[0].max()) == 1 and int(got[1].max()) == mask.sum()


@pytest.mark.parametrize("fn", ["fill_holes_in_mask_scores",
                                "remove_small_sprinkles"])
def test_hole_and_sprinkle_postprocess_match_vdn(fn):
    """fill_holes_in_mask_scores / remove_small_sprinkles on float logits
    [N, 1, H, W] at max_area 8: the same values as vdn's."""
    import vdn.ops.connected_components as J
    import vdn_torch.ops.connected_components as T
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 1, 48, 56)).astype(np.float32)
    want = getattr(J, fn)(logits, 8)
    got = getattr(T, fn)(torch.from_numpy(logits), 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != logits).any()


def _masks(seed, n=5, h=24, w=32):
    m = np.random.default_rng(seed).random((n, h, w)) > 0.6
    m[0] = False
    m[1] = True
    m[2, 0, 0] = True
    m[3, 0, 0] = False
    return m


def test_rle_matches_vdn():
    """mask_to_rle / masks_to_rle (column-major, the count of 0s first),
    rle_to_mask and area_from_rle, on empty, full and random masks."""
    import vdn.ops.amg as J
    import vdn_torch.ops.amg as T
    masks = _masks(0)
    batch = T.masks_to_rle(torch.from_numpy(masks))
    for m, rle in zip(masks, batch):
        want = J.mask_to_rle(m)
        assert rle == want == T.mask_to_rle(torch.from_numpy(m))
        np.testing.assert_array_equal(T.rle_to_mask(rle).numpy(),
                                      J.rle_to_mask(want))
        assert T.area_from_rle(rle) == J.area_from_rle(want) == m.sum()


def test_stability_and_boxes_match_vdn():
    """calculate_stability_score (float64) and batched_mask_to_box
    (inclusive max-index edges, zeros for an empty mask) equal vdn's."""
    import vdn.ops.amg as J
    import vdn_torch.ops.amg as T
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 5, 16, 20)) * 3).astype(np.float32)
    logits[0, 0] = -5.0   # no pixel above either threshold
    got = T.calculate_stability_score(torch.from_numpy(logits), 0.0, 1.0)
    want = J.calculate_stability_score(logits, 0.0, 1.0)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    masks = _masks(2).reshape(5, 24, 32)
    for m in (masks, masks.reshape(5, 1, 24, 32)):
        boxes = T.batched_mask_to_box(torch.from_numpy(m))
        assert boxes.dtype == torch.float32
        np.testing.assert_array_equal(boxes.numpy(),
                                      J.batched_mask_to_box(m))
    np.testing.assert_array_equal(
        T.box_xyxy_to_xywh(boxes).numpy(), J.box_xyxy_to_xywh(
            J.batched_mask_to_box(masks.reshape(5, 1, 24, 32))))


def test_grids_and_crops_match_vdn():
    """The point grids, crop boxes and the uncrop / crop-edge helpers."""
    import vdn.ops.amg as J
    import vdn_torch.ops.amg as T
    np.testing.assert_array_equal(T.build_point_grid(32),
                                  J.build_point_grid(32))
    for a, b in zip(T.build_all_layer_point_grids(16, 2, 2),
                    J.build_all_layer_point_grids(16, 2, 2)):
        np.testing.assert_array_equal(a, b)
    assert (T.generate_crop_boxes((100, 150), 2, 0.3)
            == J.generate_crop_boxes((100, 150), 2, 0.3))
    rng = np.random.default_rng(4)
    boxes = (rng.random((6, 4)) * 90).astype(np.float32)
    crop, orig = [10, 20, 90, 100], [0, 0, 150, 100]
    np.testing.assert_array_equal(
        T.uncrop_boxes_xyxy(torch.from_numpy(boxes), crop).numpy(),
        J.uncrop_boxes_xyxy(boxes, crop))
    np.testing.assert_array_equal(
        T.uncrop_points(torch.from_numpy(boxes[:, :2]), crop).numpy(),
        J.uncrop_points(boxes[:, :2], crop))
    masks = _masks(5, 4, 80, 80)
    np.testing.assert_array_equal(
        T.uncrop_masks(torch.from_numpy(masks), crop, 100, 150).numpy(),
        J.uncrop_masks(masks, crop, 100, 150))
    np.testing.assert_array_equal(
        T.is_box_near_crop_edge(torch.from_numpy(boxes), crop,
                                orig).numpy(),
        J.is_box_near_crop_edge(boxes, crop, orig))


def _region_masks():
    """A blob with a 4-pixel hole and a 4-pixel island; two islands of 6
    pixels each and nothing else (every island small: the largest's tie
    goes to the first raster index); random masks."""
    blob = np.zeros((30, 30), bool)
    blob[5:25, 5:25] = True
    blob[10:12, 10:12] = False
    blob[0:2, 27:29] = True
    twins = np.zeros((30, 30), bool)
    twins[20:22, 3:6] = True
    twins[4:6, 24:27] = True     # the first raster index of the two
    rand = np.random.default_rng(6).random((3, 30, 30)) > 0.55
    return np.concatenate([blob[None], twins[None], rand])


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_match_vdn(mode):
    """remove_small_regions per mask and remove_small_regions_batch over
    all (one connected-components call) against vdn's, area 10: the same
    masks and the same 'changed' flags; with every island small the kept
    island is the first raster index's among the largest."""
    import vdn.ops.amg as J
    import vdn_torch.ops.amg as T
    masks = _region_masks()
    want = [J.remove_small_regions(m.copy(), 10, mode) for m in masks]
    batch, changed = T.remove_small_regions_batch(torch.from_numpy(masks),
                                                  10, mode)
    for i, (m, (w, w_mod)) in enumerate(zip(masks, want)):
        g, g_mod = T.remove_small_regions(torch.from_numpy(m), 10, mode)
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(batch[i].numpy(), w)
        assert g_mod == bool(changed[i]) == w_mod
    if mode == "islands":
        kept = batch[1].numpy()
        assert kept[4:6, 24:27].all() and kept.sum() == 6


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_nms_matches_vdn(thresh):
    """nms_boxes on 60 random boxes with distinct scores: vdn's kept
    indices in vdn's order.  At the threshold itself a box stays (IoU 0.5
    exactly at threshold 0.5), as vdn's."""
    import vdn.ops.amg as J
    import vdn_torch.ops.amg as T
    rng = np.random.default_rng(7)
    xy = rng.random((60, 2)) * 80
    wh = rng.random((60, 2)) * 40 + 1
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.permutation(60).astype(np.float64) / 60
    got = T.nms_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                      thresh)
    want = J.nms_boxes(boxes, scores, thresh)
    assert got.dtype == torch.int64
    assert got.tolist() == want.tolist() and 1 < len(want) < 60
    edge = np.array([[0, 0, 4, 1], [0, 0, 2, 1]], np.float32)
    s = np.array([0.9, 0.8])
    assert (T.nms_boxes(torch.from_numpy(edge), torch.from_numpy(s),
                        0.5).tolist()
            == J.nms_boxes(edge, s, 0.5).tolist() == [0, 1])


AMG_KW = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, box_nms_thresh=0.7,
              min_mask_region_area=20)


@pytest.fixture(scope="module")
def amg_models():
    """vdn's image predictor and the port's on tests/test_torch_sam2.py's
    seeded weights (the ``sam2_test`` trunk, image 128), and an image."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    from tests.test_torch_sam2 import SAM2_TRUNK
    from vdn.models.sam2_image import Sam2ImageModel as JI
    from vdn.models.sam2_image import Sam2ImagePredictor as JPred
    from vdn_torch.models.sam2_image import (Sam2ImagePredictor as TPred,
                                             build_sam2_image_model)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jh, th):
            mp.setitem(mod.HIERA_CONFIGS, "sam2_test", dict(SAM2_TRUNK))
        rng = np.random.default_rng(8)
        jm = JI(trunk_variant="sam2_test", d_model=D, image_size=SIZE)
        tm = build_sam2_image_model("sam2_test", SIZE, device="cpu",
                                    d_model=D)
        params = seeded_tree(tm, rng)
        img = rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)
        img[30:90, 40:100] = (230, 200, 40)
        yield JPred(jm, params), TPred(tm), img


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("segmentation", "area", "bbox", "point_coords",
                    "predicted_iou", "stability_score"):
            assert g[key] == w[key], key


class _Replay:
    """A predictor that serves vdn's predict_batch outputs as tensors."""

    def __init__(self, jpred, tpred):
        self.jpred, self.model = jpred, tpred.model

    def set_image(self, image):
        self.jpred.set_image(image)

    def predict_batch(self, **kw):
        return tuple(torch.from_numpy(np.array(x))
                     for x in self.jpred.predict_batch(**kw))


def test_amg_postprocess_matches_vdn(amg_models):
    """The port's generator on vdn's own logits (a predictor that replays
    vdn's predict_batch): the filters, boxes, NMS, the small-region pass
    (holes then islands) and the records are vdn's exactly: RLE, area,
    bbox, point, predicted IoU and stability score, in vdn's order."""
    from vdn.pipelines.sam2_amg import Sam2AutomaticMaskGenerator as JGen
    from vdn_torch.pipelines.sam2_amg import \
        Sam2AutomaticMaskGenerator as TGen
    jpred, tpred, img = amg_models
    want = JGen(jpred, **AMG_KW).generate(img)
    got = TGen(_Replay(jpred, tpred), **AMG_KW).generate(img)
    _same_records(got, want)
    # the small-region pass changed some mask
    plain = JGen(jpred, **{**AMG_KW, "min_mask_region_area": 0}).generate(
        img)
    assert ({str(r["segmentation"]) for r in plain}
            != {str(r["segmentation"]) for r in want})


def test_amg_matches_vdn(amg_models):
    """Sam2AutomaticMaskGenerator end to end (16 points in batches of 6,
    both filters at 0, NMS 0.7, min_mask_region_area 20) on the port's
    model against vdn's: the same records."""
    from vdn.pipelines.sam2_amg import Sam2AutomaticMaskGenerator as JGen
    from vdn_torch.pipelines.sam2_amg import \
        Sam2AutomaticMaskGenerator as TGen
    jpred, tpred, img = amg_models
    want = JGen(jpred, **AMG_KW).generate(img)
    got = TGen(tpred, **AMG_KW).generate(img)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("segmentation", "area", "bbox", "point_coords"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["predicted_iou"], w["predicted_iou"],
                                   rtol=1e-5)
        np.testing.assert_allclose(g["stability_score"],
                                   w["stability_score"], rtol=1e-5)
