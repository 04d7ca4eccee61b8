"""Render/text/JSON output elements.

A copy of deepdish_tpu/pipeline/elements.py (host code; the port keeps its
own), with PIL imported only where a font is loaded or an image drawn, so a
run with --disable-graphics needs no PIL.

Port of the element protocol of deepdish.py:237-440: every pipeline product
is an element with a draw priority and optional `do_render(render)`,
`do_text(handle, elements)`, `do_json(json)` methods; the render stage sorts
by priority and dispatches. Priorities, colors and payload keys match the
reference so downstream consumers (Adaptive City platform, demo scripts)
see identical output.
"""
from __future__ import annotations

import os
import numpy as np


class FontLib:
    """deepdish.py:205-224."""

    def __init__(self, display_w,
                 fontbasedirs=('.', '/usr/local/share', '/usr/share')):
        from PIL import ImageFont
        tinysize = int(24.0 / 640.0 * display_w)
        smallsize = int(40.0 / 640.0 * display_w)
        largesize = int(48.0 / 640.0 * display_w)
        fontfile = None
        for bd in fontbasedirs:
            f = os.path.join(bd, 'fonts/truetype/freefont/FreeSansBold.ttf')
            if os.path.exists(f):
                fontfile = f
                break
        def load(size):
            try:
                return ImageFont.truetype(fontfile, size)
            except Exception:
                return ImageFont.load_default()
        self.table = {'tiny': load(tinysize), 'small': load(smallsize),
                      'large': load(largesize)}

    def fetch(self, name):
        return self.table.get(name, self.table['large'])


class RenderInfo:
    def __init__(self, ratio, fontlib, draw, buffer):
        self.ratio = ratio
        self.fontlib = fontlib
        self.draw = draw
        self.buffer = buffer


def _font_size(font, text):
    try:
        l, t, r, b = font.getbbox(str(text))
        return (r - l, b - t)
    except AttributeError:  # pragma: no cover
        return font.getsize(str(text))


class FrameInfo:
    """deepdish.py:237-257."""

    def __init__(self, t_frame, framenum):
        self.t_frame = t_frame
        self.framenum = framenum
        self.priority = 0

    def do_text(self, handle, elements):
        handle.write('Frame {}:'.format(self.framenum))
        for e in elements:
            if isinstance(e, TimingInfo):
                handle.write(' {}={:.0f}ms'.format(e.short_label,
                                                   e.delta_t * 1000))
            elif isinstance(e, TempInfo):
                handle.write(' temp={:.0f}C'.format(e.temp))
            elif isinstance(e, PipelineInfo):
                handle.write(' pipe={} cpup={:.0f}%'.format(e.count, e.cpup))
        handle.write('\n')

    def do_json(self, json):
        json['framenum'] = self.framenum
        json['acp_ts'] = str(self.t_frame)


class TimingInfo:
    def __init__(self, desc, short_label, delta_t):
        self.description = desc
        self.short_label = short_label
        self.delta_t = delta_t
        self.priority = 1

    def do_json(self, json):
        json.setdefault('timing', {})[self.short_label] = \
            round(self.delta_t * 1000)


class TempInfo:
    def __init__(self, temp):
        self.temp = temp
        self.priority = 2

    def do_json(self, json):
        json['temp'] = self.temp


class PipelineInfo:
    def __init__(self, count, qsizes, cpup, freq):
        self.count = count
        self.priority = 3
        self.qsizes = qsizes
        self.cpup = cpup
        self.freq = freq

    def do_json(self, json):
        json['pipe'] = self.count
        json['qsizes'] = self.qsizes
        json['cpup'] = self.cpup
        json['freq'] = self.freq


class DetectedObject:
    def __init__(self, bbox):
        self.bbox = np.asarray(bbox)
        self.priority = 5
        self.outline = (255, 0, 0)

    def do_render(self, render):
        pts = list(np.int32(np.array(self.bbox).reshape(-1, 2)
                            * render.ratio).reshape(-1))
        render.draw.rectangle(pts, outline=self.outline)

    def do_json(self, json):
        json.setdefault('detections', []).append(
            {'bbox': np.asarray(self.bbox).astype(np.int32).tolist()})


class TrackedObject:
    def __init__(self, bbox, txt, lbl, conf, track_id, ratios):
        self.bbox = np.asarray(bbox)
        self.txt = txt
        self.label = lbl
        self.track_id = track_id
        self.confidence = conf
        self.ratios = ratios
        self.priority = 6
        self.outline = (255, 255, 255)
        self.font_fill = (0, 255, 0)
        self.font = 'tiny'

    def do_render(self, render):
        pts = list(np.int32(np.array(self.bbox).reshape(-1, 2)
                            * render.ratio).reshape(-1))
        render.draw.rectangle(pts, outline=self.outline)
        render.draw.text(tuple(self.bbox[:2]), str(self.txt),
                         fill=self.font_fill,
                         font=render.fontlib.fetch(self.font))

    def do_json(self, json):
        wr, hr = self.ratios
        bbox = self.bbox.astype(np.float32) * [wr, hr, wr, hr]
        json.setdefault('tracks', []).append(
            {'bbox': bbox.astype(np.int32).tolist(), 'label': self.label,
             'confidence': float(self.confidence),
             'track_id': int(self.track_id)})


class Line:
    def do_render(self, render):
        pts = list(np.int32(np.array(self.pts).reshape(-1, 2)
                            * render.ratio).reshape(-1))
        render.draw.line(pts, fill=self.fill, width=self.width)


class TrackedPath(Line):
    def __init__(self, pts):
        self.pts = pts
        self.priority = 3
        self.width = 3
        self.fill = (255, 0, 255)


class TrackedPathIntersection(Line):
    def __init__(self, pts):
        self.pts = pts
        self.priority = 4
        self.width = 5
        self.fill = (0, 0, 255)


class CameraCountLine(Line):
    def __init__(self, pts):
        self.pts = pts
        self.priority = 2
        self.width = 3
        self.fill = (0, 0, 255)


class CameraImage:
    def __init__(self, image):
        self.image = image
        self.priority = 1
        self.raw = True

    def do_render(self, render):
        render.buffer.paste(self.image)


class FGMask:
    def __init__(self, fgMask):
        self.fgMask = fgMask
        self.priority = 2

    def do_render(self, render):
        from PIL import Image
        render.buffer.paste(Image.fromarray(self.fgMask))


class CountingStats:
    """deepdish.py:378-408: negcount left / label centre / poscount right,
    stacked from the bottom of the frame."""

    def __init__(self, negcount, poscount):
        self.negcount = negcount
        self.poscount = poscount
        self.priority = 10
        self.font_fill_negcount = (255, 0, 0)
        self.font_fill_abscount = (0, 255, 0)
        self.font_fill_poscount = (0, 0, 255)
        self.font = 'tiny'
        self.labels = list(negcount.keys())
        self.labels.reverse()

    def do_render(self, render):
        font = render.fontlib.fetch(self.font)
        w, h = render.buffer.size
        cursor = h
        for lbl in self.labels:
            _, dy = _font_size(font, self.negcount[lbl])
            cursor -= dy
            render.draw.text((0, cursor), str(self.negcount[lbl]),
                             fill=self.font_fill_negcount, font=font)
            dx, dy = _font_size(font, lbl)
            render.draw.text(((w - dx) / 2, cursor), lbl,
                             fill=self.font_fill_abscount, font=font)
            dx, dy = _font_size(font, self.poscount[lbl])
            render.draw.text((w - dx, cursor), str(self.poscount[lbl]),
                             fill=self.font_fill_poscount, font=font)


class TopDownView:
    def __init__(self, topdownview):
        viewpos, viewsize = topdownview
        self.viewpos = np.array(viewpos, dtype=int)
        self.viewsize = np.array(viewsize, dtype=int)
        self.priority = 9

    def do_render(self, render):
        pts = list(np.array([self.viewpos,
                             self.viewpos + self.viewsize]).reshape(-1))
        render.draw.rectangle(pts, fill=(0, 0, 0))


class TopDownObj:
    def __init__(self, topdownview, pts):
        viewpos, viewsize = topdownview
        self.viewpos = np.array(viewpos, dtype=int)
        self.viewsize = np.array(viewsize, dtype=int)
        self.pts = (np.asarray(pts).reshape(-1, 2) * np.array([1, -1])
                    + np.asarray(viewsize) * np.array([0.5, 1]) + viewpos)
        self.priority = 10
        self.fill = (0, 255, 0)
        self.width = 2

    def do_render(self, render):
        half = np.array([self.width / 2.0, self.width / 2.0])
        pt0 = self.pts[-1]
        rectpts = list(np.array([pt0 - half, pt0 + half], dtype=int
                                ).reshape(-1))
        render.draw.rectangle(rectpts, fill=self.fill)
        if len(self.pts) > 1:
            linepts = [tuple(p) for p in self.pts.astype(int)]
            render.draw.line(linepts, fill=self.fill, width=1)
