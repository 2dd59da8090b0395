"""Graph (de)serialization: fast binary format + reference-compatible JSON.

A copy of gnn_tumor_seg_tpu/data/store.py (the port imports nothing of the
JAX package); files written by either package read in the other.

The reference stores graphs as networkx node-link JSON and re-parses + rebuilds
DGL graphs from them *every epoch* (`data_processing/data_loader.py:67-83`, an
identified hotspot, SURVEY §3.2). Here the native format is a flat .npz
(feats/labels/edges/centroids) that loads in milliseconds; node-link JSON
read/write is kept for interop so datasets preprocessed by either pipeline work
with both (`data_processing/graph_io.py:27-37` contract: nodes carry 'features'
and optionally 'label'; links carry source/target; undirected).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .graph_build import GraphSample

__all__ = [
    "save_graph_npz", "load_graph_npz", "peek_graph_npz",
    "save_networkx_json", "load_networkx_json",
]


def save_graph_npz(fp: str, sample: GraphSample) -> None:
    d = os.path.dirname(os.path.abspath(fp))
    if d:
        os.makedirs(d, exist_ok=True)
    payload = {
        "feats": sample.feats.astype(np.float32),
        "src": sample.src.astype(np.int32),
        "dst": sample.dst.astype(np.int32),
        "centroids": sample.centroids.astype(np.float32),
    }
    if sample.labels is not None:
        payload["labels"] = sample.labels.astype(np.int32)
    if sample.edge_weights is not None:
        payload["edge_weights"] = sample.edge_weights.astype(np.float32)
    np.savez(fp, **payload)


def load_graph_npz(fp: str) -> GraphSample:
    with np.load(fp) as z:
        return GraphSample(
            feats=z["feats"],
            labels=z["labels"] if "labels" in z.files else None,
            centroids=z["centroids"],
            src=z["src"], dst=z["dst"],
            sv_partition=None,  # stored separately as a nifti volume
            edge_weights=z["edge_weights"] if "edge_weights" in z.files else None,
        )


def peek_graph_npz(fp: str) -> tuple[int, int]:
    """(n_nodes, max_in_degree) without loading features — for shape budgeting."""
    with np.load(fp) as z:
        n = z["feats"].shape[0]
        dst = z["dst"]
        deg = np.bincount(dst, minlength=n).max() if len(dst) else 0
        return n, int(deg)


def save_networkx_json(fp: str, sample: GraphSample) -> None:
    """Write node-link JSON readable by the reference's load_networkx_graph."""
    n = sample.n_nodes
    nodes = []
    for i in range(n):
        node = {"id": i, "features": [float(x) for x in sample.feats[i]]}
        if sample.labels is not None:
            node["label"] = int(sample.labels[i])
        nodes.append(node)
    # store each undirected edge once (source < target, plus self-loops once)
    mask = sample.src <= sample.dst
    if sample.edge_weights is not None:
        links = [
            {"source": int(s), "target": int(t), "weight": float(w)}
            for s, t, w in zip(sample.src[mask], sample.dst[mask],
                               sample.edge_weights[mask])
        ]
    else:
        links = [
            {"source": int(s), "target": int(t)}
            for s, t in zip(sample.src[mask], sample.dst[mask])
        ]
    doc = {"directed": False, "multigraph": False, "graph": {},
           "nodes": nodes, "links": links}
    d = os.path.dirname(os.path.abspath(fp))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(fp, "w") as f:
        f.write(json.dumps(doc))


def load_networkx_json(fp: str) -> GraphSample:
    """Read reference-produced node-link JSON into a GraphSample.

    Handles both undirected (edges stored once) and directed dumps; the returned
    edge list always carries both directions, with self-loops kept single.
    """
    with open(fp) as f:
        doc = json.load(f)
    nodes = sorted(doc["nodes"], key=lambda n: n["id"])
    ids = [n["id"] for n in nodes]
    id_to_idx = {nid: i for i, nid in enumerate(ids)}
    feats = np.asarray([n["features"] for n in nodes], np.float32)
    labels = None
    if nodes and "label" in nodes[0]:
        labels = np.asarray([n["label"] for n in nodes], np.int32)
    links = doc.get("links", doc.get("edges", []))
    s = np.asarray([id_to_idx[l["source"]] for l in links], np.int32)
    t = np.asarray([id_to_idx[l["target"]] for l in links], np.int32)
    w = None
    if links and "weight" in links[0]:
        w = np.asarray([l["weight"] for l in links], np.float32)
    if not doc.get("directed", False):
        non_loop = s != t
        src = np.concatenate([s, t[non_loop]])
        dst = np.concatenate([t, s[non_loop]])
        if w is not None:
            w = np.concatenate([w, w[non_loop]])
    else:
        src, dst = s, t
    return GraphSample(
        feats=feats, labels=labels,
        centroids=np.zeros((len(ids), 3), np.float32),
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        sv_partition=None,
        edge_weights=w,
    )
