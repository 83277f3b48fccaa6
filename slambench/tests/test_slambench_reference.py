"""The reference against the port at 1/8 scale, both on the CPU where the
port's kernels are their plain versions: every output and state field
equal, frame by frame; and the reference's lane form against its single
form."""

import torch

from slambench.lib.harness import port_config, reference_config
from slambench.reference import frontend as ref
from slambench.reference import image as rim
from slambench.tests.small import scaled
from slambench.traffic import stream

SEED = 2 ** 31 + 3


def _frames(name, n):
    cfg = scaled(name, 0.125, n)
    return cfg, stream.render_sequence(cfg, "cpu")


def _equal_outputs(a, b):
    for x, y in zip(a.features, b.features):
        assert torch.equal(x, y)
    assert torch.equal(a.dyna_mask, b.dyna_mask)
    assert torch.equal(a.label_img, b.label_img)
    assert torch.equal(torch.as_tensor(a.large_motion),
                       torch.as_tensor(b.large_motion))
    assert torch.equal(a.kp_depth, b.kp_depth)


def test_reference_is_the_port_frame_by_frame():
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.ops import image as im

    config, seq = _frames("tum_fr3_walking", 8)
    cp, cr = port_config(config), reference_config(config)
    sp = fp.init_state(cp, im.rgb_to_gray(seq.rgb[0]), device="cpu",
                       seed=SEED)
    sr = ref.init_state(cr, rim.rgb_to_gray(seq.rgb[0]), device="cpu",
                        seed=SEED)
    for k in range(8):
        op, sp = fp.frontend_step(seq.rgb[k], seq.depth[k], sp, cp)
        orr, sr = ref.frontend_step(seq.rgb[k], seq.depth[k], sr, cr)
        _equal_outputs(op, orr)
        for name in ("flow_u_w", "flow_v_w", "dyn_score", "ratio_img",
                     "prev_high", "dyn_depth"):
            assert torch.equal(getattr(sp, name), getattr(sr, name)), name


def test_reference_lanes_are_each_lane_alone():
    config, seq = _frames("bonn_crowd", 12)
    cr = reference_config(config)
    idx = torch.tensor([[0, 1, 2, 3], [6, 7, 8, 9], [11, 10, 9, 8]])
    rgbs, depths = seq.rgb[idx], seq.depth[idx]
    st = ref.init_state(cr, rim.rgb_to_gray(rgbs[:, 0]), device="cpu")
    lane_out = []
    for t in range(4):
        out, st = ref.frontend_step(rgbs[:, t].contiguous(),
                                    depths[:, t].contiguous(), st, cr)
        lane_out.append(out)
    for b in range(3):
        s1 = ref.init_state(cr, rim.rgb_to_gray(rgbs[b, 0]), device="cpu")
        for t in range(4):
            o1, s1 = ref.frontend_step(rgbs[b, t], depths[b, t], s1, cr)
            assert torch.equal(o1.dyna_mask, lane_out[t].dyna_mask[b])
            assert torch.equal(o1.features.desc, lane_out[t].features.desc[b])
            assert bool(o1.large_motion) == bool(lane_out[t].large_motion[b])
