"""Key and ciphertext files (the cloud/client split).

Port of torus_fhe_tpu/utils/serialize.py, numpy and torch only. It reads and
writes the SAME files as the JAX package, so a key made by one package is
used by the other: numpy ``.npz`` with a ``__meta__`` JSON blob (schema tag,
kind, the parameter set as class name plus field values) and the arrays,
either positional (``leaf_i``, in the order the JAX package's pytree flatten
gives: dict entries by sorted key) or named (``k_<name>``, optional fields
left out).

A cloud key is stored compact: the keyswitch table and the raw TGSW samples,
with the forms the key held (``conv``, ``fblock``), as the JAX package
records them. The rotate's key forms are rebuilt from the samples on load,
on ``device`` (None: the card, core/device.resolve_device; ``"cpu"``: the
CPU): ``forms`` names them, and without it a single-key file loads in this
package's default form, ``fblock``, whatever it recorded; a 3gen file whose
only form is ``conv`` loads as the exact key of the raw samples' lines
(mk/keys3gen.py), the exact chain JAX's conv scan runs; a legacy file that
holds conv kernels and no samples cannot be loaded. The CCS and KMS cloud
keys are stored by the JAX package's field names, in the forms they hold
(``fb`` lines, ``conv`` packed kernels); a file in either form loads in
either (``forms``, default ``fb``), each form's fields taken as they are
where the file holds them and rebuilt from the other's otherwise. The
keyswitch tables are
written without the zero columns this package pads them with
(boot/keyswitch.pad_table), so that the JAX package reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import torch

from ..core import params as P
from ..core.device import resolve_device

_SCHEMA = "torus_fhe_tpu.v1"
NO_SAMPLES = ("{path} holds the conv kernels of the JAX package's scan backend and no raw "
              "samples (a legacy file): this package builds every form from the samples. Save "
              "the key again with its samples")


def _params_to_json(params) -> str:
    d = {"__class__": type(params).__name__}
    d.update(dataclasses.asdict(params))
    return json.dumps(d)


def _params_from_json(s: str):
    d = json.loads(s)
    return getattr(P, d.pop("__class__"))(**d)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _write(path: str, meta: dict, payload: dict, params) -> None:
    """Write the file whole or not at all: under ``path + ".tmp"``, renamed
    into place once written, the ``.tmp`` removed if writing raises. A run
    killed mid-write leaves no truncated file at ``path`` for a later load."""
    if params is not None:
        meta["params"] = _params_to_json(params)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
        raise


def _read_meta(z) -> dict:
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("schema") != _SCHEMA:
        raise ValueError(f"schema {meta.get('schema')!r}, want {_SCHEMA!r}")
    return meta


def _leaves(tree) -> list:
    """The array leaves of nested dicts, tuples and lists, in the JAX
    package's flatten order: dict entries by sorted key, None left out."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def save(path: str, kind: str, tree, params=None) -> None:
    """Write the array leaves of ``tree`` (key, ciphertext batch, share
    set...) by position."""
    leaves = _leaves(tree)
    payload = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    _write(path, {"schema": _SCHEMA, "kind": kind, "n_leaves": len(leaves)}, payload, params)


def load(path: str):
    """(kind, leaves as numpy arrays, params or None) of a positional file."""
    with np.load(path) as z:
        meta = _read_meta(z)
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    params = _params_from_json(meta["params"]) if "params" in meta else None
    return meta["kind"], leaves, params


def save_named(path: str, kind: str, mapping: dict, params=None,
               extra_meta: dict | None = None) -> None:
    """Write a flat {name: array} mapping (None values left out), with
    optional JSON-able ``extra_meta``."""
    payload = {f"k_{name}": _host(v) for name, v in mapping.items() if v is not None}
    meta = {"schema": _SCHEMA, "kind": kind, "names": [k[2:] for k in payload]}
    if extra_meta:
        meta["extra"] = extra_meta
    _write(path, meta, payload, params)


def load_named(path: str):
    """(kind, {name: numpy array}, params or None, extra_meta) of a named
    file; ValueError on a positional one."""
    with np.load(path) as z:
        meta = _read_meta(z)
        if "names" not in meta:
            raise ValueError(f"{path} is a positional-format file, not named")
        arrs = {name: z[f"k_{name}"] for name in meta["names"]}
    params = _params_from_json(meta["params"]) if "params" in meta else None
    return meta["kind"], arrs, params, meta.get("extra", {})


def _want_kind(kind: str, want: str, path: str) -> None:
    if kind != want:
        raise ValueError(f"{path} holds a {kind!r}, not a {want!r}")


def _load_key_file(path: str, want: str):
    """(arrays, params, extra) of a named cloud-key file with its raw
    samples; ValueError on the legacy layouts (positional, or conv kernels
    only)."""
    try:
        kind, arrs, params, extra = load_named(path)
    except ValueError as err:
        if "positional-format" not in str(err):
            raise
        _want_kind(load(path)[0], want, path)
        raise ValueError(NO_SAMPLES.format(path=path)) from None
    _want_kind(kind, want, path)
    if "samples" not in arrs:
        raise ValueError(NO_SAMPLES.format(path=path))
    return arrs, params, extra


def save_secret_key(path: str, sk) -> None:
    save(path, "secret_key", sk.key, params=sk.params)


def load_secret_key(path: str, device=None):
    from ..boot.api import SecretKey
    from ..lwe import LweKey

    kind, leaves, params = load(path)
    _want_kind(kind, "secret_key", path)
    return SecretKey(params, LweKey(torch.tensor(np.asarray(leaves[0], np.int32),
                                                device=resolve_device(device))))


def save_cloud_key(path: str, ck) -> None:
    """The compact cloud key: keyswitch table and raw TGSW samples (~20 MB at
    the 128-bit sets), with the forms the key holds; each is rebuilt from
    the samples on load."""
    ks, bk = ck.keyswitch_key, ck.bootstrap_key
    forms = [f for f, v in (("conv", bk.kernels), ("fblock", bk.fb)) if v is not None]
    save_named(path, "cloud_key",
               {"ks": ks.mat[:, :(ks.n_out + 1) * 4], "ks_meta": np.array([ks.n_in, ks.n_out]),
                "samples": bk.samples},
               params=ck.params, extra_meta={"forms": forms})


def load_cloud_key(path: str, forms=None, device=None):
    """Load a cloud key and build ``forms`` of its bootstrapping key on
    ``device`` ("conv" and/or "fblock"; default ("fblock",), this package's
    form, whatever the file recorded)."""
    from ..boot.api import CloudKey
    from ..boot.bootstrap import check_forms, rebuild_bk_forms
    from ..boot.keyswitch import KeyswitchKey, pad_table

    forms = check_forms(("fblock",) if forms is None else forms)
    arrs, params, extra = _load_key_file(path, "cloud_key")
    device = resolve_device(device)
    npdt = np.int32 if params.rlwe_bits == 32 else np.int64
    bk = rebuild_bk_forms(torch.from_numpy(arrs["samples"].astype(npdt)), params, forms, device)
    mat = pad_table(torch.from_numpy(arrs["ks"].astype(np.int8))).to(device)
    return CloudKey(params, bk, KeyswitchKey(mat, int(arrs["ks_meta"][0]),
                                             int(arrs["ks_meta"][1])))


def save_lwe(path: str, sample, params=None) -> None:
    save(path, "lwe", {"a": sample.a, "b": sample.b}, params=params)


def load_lwe(path: str, device=None):
    from ..lwe import LweSample

    kind, leaves, _ = load(path)
    _want_kind(kind, "lwe", path)
    device = resolve_device(device)
    return LweSample(torch.tensor(np.asarray(leaves[0], np.int32), device=device),
                     torch.tensor(np.asarray(leaves[1], np.int32), device=device))


def save_mk_cloud_key(path: str, ck) -> None:
    """The 3gen multikey cloud key, compact: the party-concatenated keyswitch
    tables and the raw 64-bit samples (keygen with ``keep_samples=True``),
    from which any form is rebuilt on load. The file records the key's
    forms; an exact key at a hi-word set records ``conv``."""
    from ..mk import keys3gen

    if ck.bk_samples is None:
        raise ValueError("the cloud key does not hold its raw samples: make it with "
                         "keep_samples=True")
    if ck.exact and keys3gen.mk_fb_supported(ck.params):
        forms = ["conv"]  # the exact lines of a hi-word set: the JAX package's exact form
    else:
        forms = [f for f, v in (("fblock", ck.bk_fb), ("fbstream", ck.bk_fb_sel)) if v is not None]
    cols = ck.parties * (ck.params.lwe_size + 1) * 4
    save_named(path, "mk_cloud_key", {"ks": ck.ks_mat[:, :cols], "samples": ck.bk_samples},
               params=ck.params, extra_meta={"parties": ck.parties, "forms": forms})


def load_mk_cloud_key(path: str, forms=None, device=None):
    """Load a 3gen cloud key and build ``forms`` on ``device``: default the
    file's forms, without conv where the file has a fast form beside it; a
    file whose only form is conv loads as the exact key (``("conv",)``); a
    file without forms takes ``default_forms(params, parties)``. A
    wide-digit set (16 parties and up) takes ("fbstream",), the lines of the
    raw 64-bit samples."""
    from ..mk import keys3gen

    arrs, params, extra = _load_key_file(path, "mk_cloud_key")
    parties = int(extra["parties"])
    if forms is None:
        saved = tuple(extra.get("forms", ()))
        forms = ("conv",) if saved == ("conv",) else \
            tuple(f for f in saved if f != "conv") or keys3gen.default_forms(params, parties)
    return keys3gen.cloud_key_from_samples(
        params, arrs["samples"].astype(np.int64), torch.from_numpy(arrs["ks"].astype(np.int8)),
        parties, tuple(forms), resolve_device(device), keep_samples=True)


_CCS_FIELDS = ("d_kern", "f0_kern", "f1_kern", "pk_kern", "sk_kern",
               "ks_mats", "d_sel", "f0_sel", "f1_sel", "pk_fb", "sk_fb")
_KMS_FIELDS = ("gsw_kern", "d_kern", "f0_kern", "f1_kern", "pk_kern",
               "sk_kern", "ks_mats", "gsw_sel")


def _save_scheme_key(path: str, kind: str, names: tuple, ck) -> None:
    """A CCS or KMS cloud key under the JAX package's field names (those
    this package's key holds; the keyswitch tables without their padding
    columns), with ``parties`` in the extra metadata."""
    fields = {f: getattr(ck, f, None) for f in names}
    fields["ks_mats"] = ck.ks_mats[..., :(ck.params.lwe_size + 1) * 4]
    save_named(path, kind, fields, params=ck.params, extra_meta={"parties": ck.parties})


def save_ccs_cloud_key(path: str, ck) -> None:
    """The CCS cloud key in the forms it holds: the d1/f0/f1 lines and the
    expanded public and shared keys (fb), the packed d1/f0/f1 kernels
    (conv), the packed public and shared keys, the keyswitch tables; the JAX
    package loads and runs either form."""
    _save_scheme_key(path, "ccs_cloud_key", _CCS_FIELDS, ck)


def load_ccs_cloud_key(path: str, device=None, forms=("fb",)):
    """Load a CCS cloud key onto ``device`` in ``forms`` ("fb" and/or
    "conv"), from a file in either JAX form (``ccs.cloud_key_from_fields``)."""
    from ..mk import ccs

    kind, arrs, params, extra = load_named(path)
    _want_kind(kind, "ccs_cloud_key", path)
    return ccs.cloud_key_from_fields(params, int(extra["parties"]), arrs, resolve_device(device),
                                     forms)


def save_kms_cloud_key(path: str, ck) -> None:
    """The KMS cloud key in the forms it holds: the TGSW lines (fb) and/or
    kernels (conv), the packed uni, public and shared kernels, the keyswitch
    tables."""
    _save_scheme_key(path, "kms_cloud_key", _KMS_FIELDS, ck)


def load_kms_cloud_key(path: str, device=None, forms=("fb",)):
    """Load a KMS cloud key onto ``device`` in ``forms`` ("fb" and/or
    "conv"), from a file in either JAX form (``kms.cloud_key_from_fields``)."""
    from ..mk import kms

    kind, arrs, params, extra = load_named(path)
    _want_kind(kind, "kms_cloud_key", path)
    return kms.cloud_key_from_fields(params, int(extra["parties"]), arrs, resolve_device(device),
                                     forms)


def save_share_set(path: str, repo) -> None:
    keys = sorted(repo.shares)
    save(path, "share_set",
         {"tp": np.array([repo.t, repo.p]), "index": np.array(keys, np.int64),
          "shares": np.stack([repo.shares[k] for k in keys])})


def load_share_set(path: str):
    from ..threshold.shares import ShareSet

    kind, leaves, _ = load(path)
    _want_kind(kind, "share_set", path)
    index, shares, tp = leaves  # sorted keys: index, shares, tp
    repo = ShareSet(int(tp[0]), int(tp[1]))
    for (party, gid), s in zip(index.tolist(), shares):
        repo.shares[(int(party), int(gid))] = s
    return repo
