"""The comparison that decides `correct`: what the timed window produced
against the plain reference (`reference/`), on streams and calls drawn
from the seed.

For each sampled stream the reference works the stream out again from the
host I420 frames the program was handed:
  * its own I420 -> RGB conversion (`rgb_off`: bytes of the program's RGB
    frame that differ, on the sampled calls);
  * with MOG2 on, its own MOG2 over every call of the window
    (`fg_off`: elements of the program's foreground integral image that
    differ on the sampled calls; `mog2_off`: elements of the program's
    final MOG2 state that differ);
  * on the sampled calls, the detector's checks of the configuration's
    family (`det_gap`, `det2_gap`, `post_off`; see `families/`), the box
    filters and pipeline NMS run on the program's raw detections with the
    reference's own foreground integral (`filter_off`: elements of the
    program's detections that differ), and MARS on the reference's crops
    of its own RGB frame at the program's boxes (`mars_gap`: the largest
    L2 distance between the program's unit feature and the reference's);
  * the tracker over every call of the window, on the program's
    detections (`track_off`: elements of the program's track outputs that
    differ), and the countline counters on the reference's track outputs
    (`count_off`: the summed |difference| of every counter).

Each stage after the frames takes the program's own output of the stage
before it: random weights make the detections chaotic under rounding (a
bf16 network picks other near-tied boxes than a float32 one), so a whole
rerun would not follow the program; each stage is judged on the same
inputs instead. Floats are compared by a gap, everything else exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference import bgsub as ref_bgsub
from reference import colorspace as ref_color
from reference import counting as ref_counting
from reference import step as ref_step
from reference import tracker as ref_tt


def step_config(config: dict, traffic: dict) -> ref_step.StepConfig:
    st = config["step"]
    return ref_step.StepConfig(
        nms_max_overlap=float(st["nms_max_overlap"]),
        spurious_area_frac=float(st["spurious_area_frac"]),
        score_threshold=float(st["score_threshold"]),
        background_ratio=float(traffic["background_ratio"]),
        max_detections=int(config["tracker"]["max_detections"]),
        encode_capacity=int(st["encode_capacity"]))


def tracker_config(config: dict, traffic: dict) -> ref_tt.TrackerConfig:
    t = config["tracker"]
    return ref_tt.TrackerConfig(
        max_tracks=int(t["max_tracks"]),
        max_detections=int(t["max_detections"]),
        feature_dim=int(config["encoder"]["feature_dim"]),
        gallery_size=int(t["gallery_size"]),
        pending_size=int(t["pending_size"]),
        num_labels=len(traffic["labels"]),
        max_cosine_distance=float(t["max_cosine_distance"]),
        max_iou_distance=float(t["max_iou_distance"]),
        max_age=int(t["max_age"]), n_init=int(t["n_init"]),
        gating_threshold=float(t["gating_threshold"]))


def countline(traffic: dict) -> np.ndarray:
    x = float(traffic["line_x"])
    return np.array([[x, 0.0], [x, float(traffic["height"])]])


def _off(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    return int((a != b).sum())


def compare(cell, fam, checker, mars, traffic, win, recorder, countings,
            streams, calls, device, control=None) -> Dict[str, float]:
    """The numbers of the comparison (see the module docstring). With
    `control` ((detector net, MARS net): copies of the reference's in a
    lower precision), also "control": the numbers with that control in the
    program's place, its networks' gaps on the same frames and boxes and
    the program's numbers of the stages it does not replace, for
    `judge`."""
    cfg, tr = cell.config, cell.traffic
    H, W = int(tr["height"]), int(tr["width"])
    F = int(tr["frames_per_call"])
    bgsub_on = bool(tr["background_subtraction"])
    scfg = step_config(cfg, tr)
    tcfg = tracker_config(cfg, tr)
    lut = ref_step.label_lut(fam.labels(cfg), tr["labels"], device)
    E = scfg.encode_capacity
    out = {"rgb_off": 0, "post_off": 0, "filter_off": 0,
           "mars_gap": 0.0, "track_off": 0, "count_off": 0}
    if bgsub_on:
        out.update(fg_off=0, mog2_off=0)
    ctrl = {"mars_gap": 0.0}
    sampled = set(calls)
    per_shard = int(tr["streams"]) // len(recorder.calls[0]["dets"])
    for s in streams:
        shard, local = divmod(s, per_shard)
        bg = (ref_bgsub.init_state(H, W, device) if bgsub_on else None)
        table = ref_tt.create_table(tcfg, device)
        counter = ref_counting.CountingState(tr["labels"], countline(tr))
        for c in range(win.calls):
            dets = recorder.calls[c]["dets"][shard]
            need_rgb = bgsub_on or c in sampled
            if need_rgb:
                yuv = torch.from_numpy(
                    traffic.calls[c % traffic.period][s]).to(device)
                rgb = ref_color.yuv420_to_rgb_u8(yuv, H, W)
            for f in range(F):
                i = local * F + f
                integral = None
                if bgsub_on:
                    bg, mask = ref_bgsub.update(bg, rgb[f])
                    integral = ref_step.foreground_integral(mask)[None]
                if c in sampled:
                    taps = recorder.shard(c, shard)
                    out["rgb_off"] += int((taps["rgb"][i] != rgb[f]).sum())
                    if bgsub_on:
                        out["fg_off"] += int(
                            (taps["integral"][i] != integral[0]).sum())
                    nums = checker.check_frame(taps, i, rgb[f][None], W, H)
                    out["post_off"] += nums.pop("post_off")
                    for k, v in nums.items():
                        out[k] = max(out.get(k, 0.0), v)
                    raw = [x[i:i + 1] for x in taps["raw"]]
                    snap = ref_step.filter_and_nms(scfg, lut, H, W, integral,
                                                   *raw)
                    prog = (dets.tlwh[i:i + 1], dets.label[i:i + 1],
                            dets.confidence[i:i + 1], dets.valid[i:i + 1])
                    out["filter_off"] += sum(int((a != b).sum())
                                             for a, b in zip(snap, prog))
                    feats, ok = ref_step.embed_boxes(
                        mars, rgb[f][None], prog[0][:, :E], prog[3][:, :E])
                    fp = dets.feature[i:i + 1, :E]
                    dist = torch.where(ok, (fp - feats).norm(dim=-1), 0.0)
                    out["mars_gap"] = max(out["mars_gap"], float(dist.max()))
                    if control is not None:
                        _control(checker, control, ctrl, taps, i,
                                 rgb[f][None], W, H, feats, ok, prog, E)
                d = ref_tt.Detections(*(x[i] for x in dets))
                table, tout = ref_tt.step(tcfg, table, d)
                host = type(tout)(*(t.cpu().numpy() for t in tout))
                prog_out = win.outs[c]
                out["track_off"] += sum(_off(a, b[s, f]) for a, b in
                                        zip(host, prog_out))
                counter.process(host)
        if bgsub_on:
            final = win.states.stream(s).bg
            out["mog2_off"] += sum(int((a != b).sum()) for a, b in
                                   zip(bg, final))
        ref_c = counter.counters_payload()
        prog_c = countings[s].counters_payload()
        out["count_off"] += sum(abs(ref_c[k] - prog_c[k]) for k in ref_c)
    if control is not None:
        out["control"] = {**out, **ctrl}
    return out


def _control(checker, control, ctrl, taps, i, rgb, W, H, feats, ok, prog,
             E):
    """The control's gaps on one frame: its heads in the program's place,
    its MARS features at the program's boxes."""
    det, mars = control
    nums = checker.check_frame(taps, i, rgb, W, H, control=det)
    for k, v in nums.items():
        ctrl[k] = max(ctrl.get(k, 0.0), v)
    fc, _ = ref_step.embed_boxes(mars, rgb, prog[0][:, :E], prog[3][:, :E])
    dist = torch.where(ok, (fc - feats).norm(dim=-1), 0.0)
    ctrl["mars_gap"] = max(ctrl["mars_gap"], float(dist.max()))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number that has a limit at
    or under it; a number the limits name and the run lacks fails."""
    rows = [(k, numbers.get(k, float("nan")), float(lim))
            for k, lim in limits.items()]
    return all(v <= lim for _k, v, lim in rows), rows
