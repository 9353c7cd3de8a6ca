"""Hierarchy visualization: a self-contained collapsible-tree HTML.

Counterpart of ``nbdt_tpu/hierarchy/vis.py``: the same ``build_tree`` dict,
template, options and colour palettes, so that for one graph and one set of
options both packages write the same bytes (the page's header keeps the
JAX package's "nbdt-tpu hierarchy" title for that reason). Plain Python:
PIL is imported only to embed leaf images.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..utils import Colors, makeparentdirs
from .digraph import Digraph, get_root, read_graph


def build_tree(
    G: Digraph,
    root: str,
    color_path_to: Optional[str] = None,
    edge_probs: Optional[Dict[str, float]] = None,
    color: str = "#1f77b4",
    highlight_color: str = "#d62728",
    color_leaves: bool = True,
    leaf_color: str = "#2ca02c",
    sublabels: bool = False,
    fake_sublabels: bool = False,
    hide: Sequence[str] = (),
    force_labels_left: Sequence[str] = (),
    color_nodes: Sequence[str] = (),
    wnid_to_image=None,
    image_size: int = 32,
    image_resize_factor: float = 1.0,
    node_conf: Sequence = (),
) -> dict:
    """Recursive d3-style dict: {name, id, children, color[, prob, sublabel]}
    (reference hierarchy.py:221-303).

    - ``color_path_to``: highlight every node on the root path of this
      wnid/label (reference --vis-color-path-to).
    - ``hide``: wnids whose subtrees are dropped (reference --vis-hide).
    - ``sublabels``: annotate nodes with their wnid (--vis-sublabels);
      ``fake_sublabels`` includes generated f-wnids too.
    - ``force_labels_left``: node names whose labels render on the left
      (reference --vis-force-labels-left).
    - ``wnid_to_image``: leaf wnid -> image (HWC uint8 array or PIL image),
      embedded base64 into the HTML (reference --vis-leaf-images,
      hierarchy.py:255-303); ``image_resize_factor`` scales the rendered
      size (reference --vis-image-resize-factor).
    - ``color_nodes``: extra wnids/labels rendered in the highlight color
      (reference --vis-color-nodes, hierarchy.py:435).
    - ``node_conf``: (wnid, key, value) triplets that override any field of
      the matching node dict, dot-notation keys supported (reference
      --vis-node-conf / generate_node_conf, hierarchy.py:481-490).
    """
    hidden = set(hide)
    highlight = set()
    if color_path_to is not None:
        # accept a wnid or a label; walk up from the target to the root
        target = None
        if color_path_to in G:
            target = color_path_to
        else:
            for w in G.nodes:
                if G.label(w) == color_path_to:
                    target = w
                    break
        cur = target
        while cur is not None:
            highlight.add(cur)
            preds = G.pred(cur)
            cur = preds[0] if preds else None

    force_left = set(force_labels_left)
    colored = set(color_nodes)
    conf: Dict[str, list] = {}
    for entry in node_conf:
        wnid, key, value = entry
        conf.setdefault(wnid, []).append((key, value))

    def set_dot_notation(obj: dict, key: str, value) -> None:
        """a.b.c-style key setter (reference hierarchy.py:199-210)."""
        parts = key.split(".")
        for p in parts[:-1]:
            obj = obj.setdefault(p, {})
        obj[parts[-1]] = value

    def rec(wnid: str) -> Optional[dict]:
        if wnid in hidden:
            return None
        label = G.label(wnid) or wnid
        is_leaf = not G.succ(wnid)
        node_color = (
            highlight_color
            if wnid in highlight or wnid in colored or label in colored
            else (leaf_color if is_leaf and color_leaves else color)
        )
        node = {"name": label, "id": wnid, "color": node_color}
        if sublabels and (fake_sublabels or not wnid.startswith("f")):
            node["sublabel"] = wnid
        if label in force_left or wnid in force_left:
            node["labelLeft"] = True
        if edge_probs and wnid in edge_probs:
            node["prob"] = round(float(edge_probs[wnid]), 4)
        if wnid_to_image is not None and is_leaf and wnid in wnid_to_image:
            node["image"] = _image_data_uri(wnid_to_image[wnid], image_size)
            node["imageSize"] = int(round(image_size * image_resize_factor))
        children = [c for c in (rec(ch) for ch in G.succ(wnid)) if c]
        if children:
            node["children"] = children
        for key, value in conf.get(wnid, []):
            set_dot_notation(node, key, value)
        return node

    out = rec(root)
    assert out is not None, f"root {root!r} is hidden"
    return out


def _image_data_uri(image, size: int = 32) -> str:
    """array/PIL image -> base64 PNG data URI for inline embedding."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    if not hasattr(image, "save"):
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255 if arr.max() <= 1.5 else arr, 0, 255
                          ).astype(np.uint8)
        image = Image.fromarray(arr)
    image = image.resize((size, size))
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>CONFIG_TITLE</title>
<style>
  body { font-family: -apple-system, Helvetica, Arial, sans-serif; margin: 0;
         background: var(--bg); color: var(--fg);
         --bg: CONFIG_BG; --fg: CONFIG_FG; }
  header { padding: 12px 20px; background: color-mix(in srgb, var(--bg) 92%, var(--fg)); border-bottom: 1px solid color-mix(in srgb, var(--bg) 80%, var(--fg)); }
  svg { display: block; margin: 0 auto; }
  .link { fill: none; stroke: color-mix(in srgb, var(--bg) 70%, var(--fg)); stroke-width: 1.5px; }
  .node circle { stroke-width: 2px; fill: var(--bg); cursor: pointer; }
  .node text { font-size: 12px; fill: var(--fg); }
  .prob { font-size: 10px; opacity: 0.6; }
  .sublabel { font-size: 9px; opacity: 0.5; }
</style>
</head>
<body>
<header><strong>CONFIG_TITLE</strong> &mdash; nbdt-tpu hierarchy CONFIG_COLORMAP</header>
<svg id="tree"></svg>
<script>
// Interactive collapsible tree, feature-matched to the reference d3.v3
// template (tree-template.html): click toggles a node's subtree with a
// 750 ms transition (children <-> _children, the reference's click()),
// collapsed nodes render filled, CONFIG collapse ids auto-collapse at load
// via dispatched click events (the reference's d3_onload/CONFIG_HIDE), and
// wheel-zoom + drag-pan replace d3.behavior.zoom.
const data = CONFIG_TREE_DATA;
const OPTS = CONFIG_OPTS;
const Z = OPTS.zoom || 1;
const NODE_H = 22 * Z + (OPTS.dy || 0), NODE_W = 170 * Z, MARGIN = (OPTS.margin || 40);
const DURATION = 750;
const NS = 'http://www.w3.org/2000/svg';
const BG = getComputedStyle(document.body).getPropertyValue('--bg').trim() || '#fff';

const svg = document.getElementById('tree');

// defs: gradient fills + the collapsed-node hatch (reference template
// gradientGray/gradientBlue/gradientBlueGreen, :68-129, and diagonalHatch,
// :191-197) — active when OPTS.gradient is set.
const defs = document.createElementNS(NS, 'defs');
function addGradient(id, c0, c1) {
  const g = document.createElementNS(NS, 'linearGradient');
  g.setAttribute('id', id);
  g.setAttribute('x1', '0%'); g.setAttribute('y1', '0%');
  g.setAttribute('x2', '100%'); g.setAttribute('y2', '100%');
  for (const [off, color] of [['0%', c0], ['100%', c1]]) {
    const s = document.createElementNS(NS, 'stop');
    s.setAttribute('offset', off);
    s.setAttribute('stop-color', color);
    g.appendChild(s);
  }
  defs.appendChild(g);
}
addGradient('gradientGray', '#bfbfbf', '#737373');
addGradient('gradientBlue', '#dfe9fb', '#5e9be7');
addGradient('gradientBlueGreen', '#00c750', '#0450b4');
const hatch = document.createElementNS(NS, 'pattern');
hatch.setAttribute('id', 'diagonalHatch');
hatch.setAttribute('patternUnits', 'userSpaceOnUse');
hatch.setAttribute('width', '4'); hatch.setAttribute('height', '4');
const hatchPath = document.createElementNS(NS, 'path');
hatchPath.setAttribute('d', 'M-1,1 l2,-2 M0,4 l4,-4 M3,5 l2,-2');
hatchPath.setAttribute('stroke', '#888');
hatchPath.setAttribute('stroke-width', '1');
hatch.appendChild(hatchPath);
defs.appendChild(hatch);
svg.appendChild(defs);

// the reference maps node color -> gradient id (gradientFill, :138-145)
function gradientFill(color) {
  if (color === '#1f77b4') return 'url(#gradientBlue)';
  if (color === '#2ca02c' || color === '#00c750')
    return 'url(#gradientBlueGreen)';
  return 'url(#gradientGray)';
}

if (OPTS.strokeWidth) {
  const st = document.createElement('style');
  st.textContent = `.link { stroke-width: ${OPTS.strokeWidth}px; }`;
  document.head.appendChild(st);
}

const rootG = document.createElementNS(NS, 'g');
svg.appendChild(rootG);

// --- zoom (wheel) + pan (drag): the d3.behavior.zoom equivalent ---------
const view = {x: 0, y: 0, k: OPTS.scale || 1};
function applyView() {
  rootG.setAttribute('transform',
    `translate(${view.x},${view.y}) scale(${view.k})`);
}
svg.addEventListener('wheel', e => {
  e.preventDefault();
  const f = Math.exp(-e.deltaY * 0.002);
  const r = svg.getBoundingClientRect();
  const px = e.clientX - r.left, py = e.clientY - r.top;
  view.x = px - (px - view.x) * f;
  view.y = py - (py - view.y) * f;
  view.k *= f;
  applyView();
}, {passive: false});
let dragState = null;
svg.addEventListener('mousedown', e => {
  dragState = {x: e.clientX - view.x, y: e.clientY - view.y};
});
window.addEventListener('mousemove', e => {
  if (!dragState) return;
  view.x = e.clientX - dragState.x;
  view.y = e.clientY - dragState.y;
  applyView();
});
window.addEventListener('mouseup', () => { dragState = null; });

// --- tree state ----------------------------------------------------------
const all = [];
(function init(n, parent) {
  n.parent = parent;
  all.push(n);
  (n.children || []).forEach(c => init(c, n));
})(data, null);

function visibleNodes() {
  const out = [];
  (function rec(n) { out.push(n); (n.children || []).forEach(rec); })(data);
  return out;
}

function layout() {
  const state = {nextY: MARGIN + (OPTS.marginTop || 0)};
  (function rec(n, depth) {
    n.depth = depth;
    if (n.children && n.children.length) {
      const ys = [];
      for (const c of n.children) { rec(c, depth + 1); ys.push(c.ty); }
      n.ty = (Math.min(...ys) + Math.max(...ys)) / 2;
    } else {
      n.ty = state.nextY; state.nextY += NODE_H;
    }
    n.tx = MARGIN + (OPTS.marginLeft || 0) + depth * NODE_W;
  })(data, 0);
  if (OPTS.rootY !== null && OPTS.rootY !== undefined) {
    const shift = OPTS.rootY - data.ty;
    visibleNodes().forEach(n => { n.ty += shift; });
    state.nextY += Math.max(shift, 0);
  }
  return state.nextY;
}

function nearestVisibleAncestor(n) {
  let p = n.parent;
  while (p) {
    if (visSet.has(p.id)) return p;
    p = p.parent;
  }
  return data;
}

function makeNode(n) {
  const g = document.createElementNS(NS, 'g');
  g.setAttribute('class', 'node');
  g.setAttribute('id', n.id);
  const c = document.createElementNS(NS, 'circle');
  c.setAttribute('r', 5 * Z);
  c.setAttribute('stroke', n.color || '#1f77b4');
  g.appendChild(c);
  const left = n.labelLeft || !!(n.children || n._children);
  const t = document.createElementNS(NS, 'text');
  t.setAttribute('dx', left ? -9 : 9);
  t.setAttribute('dy', 4);
  t.setAttribute('text-anchor', left ? 'end' : 'start');
  t.textContent = n.name;
  g.appendChild(t);
  let dy = 16;
  if (n.sublabel !== undefined) {
    const s = document.createElementNS(NS, 'text');
    s.setAttribute('dx', left ? -9 : 9);
    s.setAttribute('dy', dy);
    s.setAttribute('text-anchor', left ? 'end' : 'start');
    s.setAttribute('class', 'sublabel');
    s.textContent = n.sublabel;
    g.appendChild(s);
    dy += 11;
  }
  if (n.image !== undefined) {
    const sz = n.imageSize || 32;
    const im = document.createElementNS(NS, 'image');
    im.setAttribute('href', n.image);
    im.setAttribute('x', left ? -9 - sz - 4 : 9);
    im.setAttribute('y', dy);
    im.setAttribute('width', sz);
    im.setAttribute('height', sz);
    g.appendChild(im);
    dy += sz + 4;
  }
  if (n.prob !== undefined) {
    const pr = document.createElementNS(NS, 'text');
    pr.setAttribute('dx', left ? -9 : 9);
    pr.setAttribute('dy', dy);
    pr.setAttribute('text-anchor', left ? 'end' : 'start');
    pr.setAttribute('class', 'prob');
    pr.textContent = (n.prob * 100).toFixed(2) + '%';
    g.appendChild(pr);
  }
  g.addEventListener('click', e => {
    if (e.stopPropagation) e.stopPropagation();
    toggle(n);
  });
  return g;
}

function linkPath(ax, ay, bx, by) {
  if (OPTS.curved === false) return `M${ax},${ay} L${bx},${by}`;
  const mx = (ax + bx) / 2;
  return `M${ax},${ay} C${mx},${ay} ${mx},${by} ${bx},${by}`;
}

// Text-background rects (reference nodeEnter.insert("rect", ...) filled
// with CONFIG_TEXT_RECT_COLOR, :518-543) — measured after DOM insertion.
function addTextRects(g) {
  if (!OPTS.textRect) return;
  for (const t of Array.from(g.querySelectorAll('text'))) {
    const b = t.getBBox();
    const r = document.createElementNS(NS, 'rect');
    r.setAttribute('x', b.x);
    r.setAttribute('y', b.y);
    r.setAttribute('width', b.width);
    r.setAttribute('height', b.height);
    r.setAttribute('fill', OPTS.textRect);
    g.insertBefore(r, t);
  }
}

// Toggle children on click (reference template click()).
function toggle(n) {
  if (n.children) {
    n._children = n.children;
    n.children = null;
  } else if (n._children) {
    n.children = n._children;
    n._children = null;
  } else {
    return; // leaf
  }
  update();
}

let visSet = new Set();
function update() {
  layout();
  visSet = new Set(visibleNodes().map(n => n.id));
  for (const n of all) {
    const shown = visSet.has(n.id);
    if (!n.g && shown) {
      // enter: appear at the nearest visible ancestor's current position
      const anc = nearestVisibleAncestor(n);
      n.x = (anc.x !== undefined ? anc.x : anc.tx);
      n.y = (anc.y !== undefined ? anc.y : anc.ty);
      n.g = makeNode(n);
      rootG.appendChild(n.g);
      addTextRects(n.g);
      if (n.parent) {
        n.link = document.createElementNS(NS, 'path');
        n.link.setAttribute('class', 'link');
        rootG.insertBefore(n.link, rootG.firstChild);
      }
    }
    if (!n.g) continue;
    if (shown) {
      n.g.style.display = '';
      if (n.link) n.link.style.display = '';
      // re-expanded before the exit animation finished: the cancelled
      // animation never ran its completion pass, so clear the pending
      // hide or the NEXT animation's completion would hide shown nodes
      n.hideAfter = false;
      // collapsed indicator: hatch fill in gradient mode (the reference's
      // url(#diagonalHatch), :554), filled circle otherwise
      n.g.querySelector('circle').setAttribute(
        'fill', n._children
          ? (OPTS.gradient ? 'url(#diagonalHatch)' : (n.color || '#1f77b4'))
          : (OPTS.gradient ? gradientFill(n.color) : BG));
    } else {
      // exit: slide to the nearest visible ancestor, then hide
      const anc = nearestVisibleAncestor(n);
      n.tx = anc.tx; n.ty = anc.ty;
      n.hideAfter = true;
    }
  }
  animate();
}

let animToken = 0;
function animate() {
  const token = ++animToken;
  const t0 = performance.now();
  const starts = all.map(n => ({n, x: n.x !== undefined ? n.x : n.tx,
                                y: n.y !== undefined ? n.y : n.ty}));
  function frame(t) {
    if (token !== animToken) return;
    const p = Math.min(1, (t - t0) / DURATION);
    const e = p * (2 - p); // ease-out
    for (const s of starts) {
      const n = s.n;
      if (!n.g) continue;
      n.x = s.x + (n.tx - s.x) * e;
      n.y = s.y + (n.ty - s.y) * e;
      n.g.setAttribute('transform', `translate(${n.x},${n.y})`);
      if (n.link && n.parent) {
        n.link.setAttribute('d', linkPath(n.parent.x !== undefined ?
          n.parent.x : n.parent.tx, n.parent.y !== undefined ?
          n.parent.y : n.parent.ty, n.x, n.y));
      }
    }
    if (p < 1) {
      requestAnimationFrame(frame);
    } else {
      for (const s of starts) {
        const n = s.n;
        if (n.hideAfter && n.g) {
          n.g.style.display = 'none';
          if (n.link) n.link.style.display = 'none';
          n.hideAfter = false;
        }
      }
    }
  }
  requestAnimationFrame(frame);
}

// initial sizing from the fully-expanded layout; zoom/pan handles overflow
const bottom = layout();
const fullNodes = visibleNodes();
const width = OPTS.width ||
  (Math.max(...fullNodes.map(n => n.tx)) + NODE_W + MARGIN);
const height = OPTS.height || (bottom + MARGIN);
const S = OPTS.scale || 1;
svg.setAttribute('width', width * S);
svg.setAttribute('height', height * S);
applyView();
for (const n of all) { n.x = n.tx; n.y = n.ty; }
update();

// auto-collapse configured subtrees at load (reference d3_onload: it
// dispatches click events on CONFIG_HIDE element ids)
for (const id of (OPTS.collapse || [])) {
  const el = document.getElementById(id);
  if (el) el.dispatchEvent(new Event('click'));
}

// auto-print mode (reference d3_onload's CONFIG_PRINT: setTimeout(print,
// 1000) after load-time collapsing, tree-template.html:707-709)
if (OPTS.print) setTimeout(() => window.print(), 1000);
</script>
</body>
</html>
"""

_THEMES = {
    "regular": ("#ffffff", "#111111"),
    "dark": ("#111111", "#eeeeee"),
    "minimal": ("#fafafa", "#333333"),
}


def generate_vis(
    tree_data: dict,
    path_html: str,
    title: str = "hierarchy",
    theme: str = "regular",
    zoom: float = 1.0,
    curved: bool = True,
    width: int = 0,
    height: int = 0,
    margin_top: int = 0,
    margin_left: int = 0,
    above_dy: int = 0,
    below_dy: int = 0,
    scale: float = 1.0,
    root_y: Optional[float] = None,
    colormap: Optional[str] = None,
    collapse: Sequence[str] = (),
    _print: bool = False,
    text_rect: Optional[str] = None,
    stroke_width: Optional[float] = None,
    gradient: bool = False,
) -> str:
    """Template substitution (reference hierarchy.py:344-411 mechanism).

    ``scale`` scales the whole rendering (reference --vis-scale, distinct
    from zoom which also spreads the layout); ``root_y`` pins the root's
    vertical position (reference --vis-root-y); ``colormap`` embeds a
    legend image in the header when the file exists (reference
    --vis-colormap, hierarchy.py:395-401); ``collapse`` lists wnids whose
    subtrees start collapsed — auto-clicked at load exactly like the
    reference's CONFIG_HIDE/d3_onload (the subtree stays expandable by
    click, unlike ``hide`` which drops it from the data).

    ``_print`` auto-opens the browser print dialog 1 s after load
    (reference CONFIG_PRINT, hierarchy.py:356/377); ``text_rect`` draws a
    background rect of that CSS color behind every label (reference
    CONFIG_TEXT_RECT_COLOR, its default rgba(255,255,255,0.8));
    ``stroke_width`` overrides the link stroke width (reference
    CONFIG_STROKE_WIDTH); ``gradient`` fills node circles with the
    reference's gray/blue/blue-green linear gradients and hatches
    collapsed nodes (tree-template.html:68-145, 191-197, 554)."""
    bg, fg = _THEMES.get(theme, _THEMES["regular"])
    opts = {
        "zoom": zoom,
        "curved": curved,
        "width": width or None,
        "height": height or None,
        "marginTop": margin_top,
        "marginLeft": margin_left,
        "dy": above_dy + below_dy,
        "scale": scale,
        "rootY": None if root_y in (None, "null") else float(root_y),
        "collapse": list(collapse),
        "print": bool(_print),
        "textRect": text_rect,
        "strokeWidth": stroke_width,
        "gradient": bool(gradient),
    }
    colormap_html = ""
    if isinstance(colormap, str) and os.path.exists(colormap):
        colormap_html = (
            f'<img src="{colormap}" style="height: 32px; float: right;">'
        )
    html = (
        _TEMPLATE.replace("CONFIG_TITLE", title)
        .replace("CONFIG_TREE_DATA", json.dumps(tree_data))
        .replace("CONFIG_OPTS", json.dumps(opts))
        .replace("CONFIG_BG", bg)
        .replace("CONFIG_FG", fg)
        .replace("CONFIG_COLORMAP", colormap_html)
    )
    makeparentdirs(path_html)
    with open(path_html, "w") as f:
        f.write(html)
    Colors.green(f"==> Wrote HTML to {path_html}")
    return path_html


# Named highlight palettes (reference graph.py:119-126 --color choices).
# Each maps to (base_color, leaf_color, highlight_color): the reference
# grays every non-colored node and uses the chosen color for colored
# leaves, colored nodes, AND the root-path highlight (hierarchy.py:414-467,
# get_color_info's "gray" default) — so the highlight actually stands out.
# "blue-green" keeps green leaves, "blue-minimal" uses a lighter accent.
_COLOR_PALETTES = {
    "blue": ("#999999", "#1f77b4", "#1f77b4"),
    "blue-green": ("#999999", "#2ca02c", "#1f77b4"),
    "blue-minimal": ("#bbbbbb", "#9ecae1", "#3182bd"),
}


def generate_hierarchy_vis_from(
    G: Digraph,
    dataset: Optional[str] = None,
    path_html: str = "out/hierarchy.html",
    color_path_to: Optional[str] = None,
    edge_probs: Optional[Dict[str, float]] = None,
    vis_root: Optional[str] = None,
    hide: Sequence[str] = (),
    sublabels: bool = False,
    fake_sublabels: bool = False,
    color_leaves: bool = True,
    force_labels_left: Sequence[str] = (),
    color_nodes: Sequence[str] = (),
    node_conf: Sequence = (),
    wnid_to_image=None,
    image_resize_factor: float = 1.0,
    color: Optional[str] = None,
    **vis_kwargs,
) -> str:
    """Programmatic entry point (reference hierarchy.py:513-604).

    ``color`` selects a named highlight palette (reference --color,
    graph.py:119-126); None keeps this repo's default green/red scheme."""
    root = vis_root or get_root(G)
    palette = {}
    if color is not None:
        base_color, leaf_color, highlight_color = _COLOR_PALETTES[color]
        palette = {"color": base_color, "leaf_color": leaf_color,
                   "highlight_color": highlight_color}
    tree_data = build_tree(
        G, root,
        color_path_to=color_path_to,
        edge_probs=edge_probs,
        color_leaves=color_leaves,
        sublabels=sublabels,
        fake_sublabels=fake_sublabels,
        hide=hide,
        force_labels_left=force_labels_left,
        color_nodes=color_nodes,
        node_conf=node_conf,
        wnid_to_image=wnid_to_image,
        image_resize_factor=image_resize_factor,
        **palette,
    )
    title = f"{dataset or 'hierarchy'}"
    return generate_vis(tree_data, path_html, title=title, **vis_kwargs)


def generate_hierarchy_vis(
    dataset: str,
    path_graph: str,
    out_dir: str = "out",
    suffix: str = "",
    out_fname: Optional[str] = None,
    **kwargs,
) -> str:
    """CLI entry point (reference hierarchy.py:493-510)."""
    G = read_graph(path_graph)
    name = out_fname or f"{Path(path_graph).stem}{suffix}"
    path_html = os.path.join(out_dir, f"{name}.html")
    return generate_hierarchy_vis_from(G, dataset=dataset, path_html=path_html, **kwargs)
