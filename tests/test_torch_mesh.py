"""Mesh builders, mesh specs and the sharded sLSTM scan.

The builders, ``parse_mesh_spec`` and ``resolve_cohort_mesh`` against the
reference's on this process's one JAX device (the port given
``devices=[cpu]``), and the clamping rule on lists of 1 to 8 repeated CPU
devices.  The sharded sLSTM scan (``Runtime(mesh=..., batch_axes=...)``)
against the unsharded one on the same reduced xLSTM: outputs and states at
1e-5 (the reference's scan tolerance; a product over fewer batch rows may
block its sums otherwise), and the gate weights' gradients, added over the
shards once, at 1e-5 of their scale.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fl import cohort as j_cohort  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import axis_devices, tree_leaves, tree_map  # noqa: E402
from repro_torch.fl import cohort  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402

CPU = torch.device("cpu")


def _cpus(n):
    return [CPU] * n


def _same(port, ref):
    assert port.axis_names == tuple(ref.axis_names)
    assert dict(port.shape) == dict(ref.shape)


@pytest.mark.parametrize("n_clients,data", [(1, 1), (3, 1), (10_000, 1),
                                            (0, 1), (4, 2), (1, 8), (2, 0)])
def test_cohort_mesh_equals_reference_on_one_device(n_clients, data):
    assert len(jax.devices()) == 1
    _same(mesh.make_cohort_mesh(n_clients, data=data, devices=_cpus(1)),
          j_mesh.make_cohort_mesh(n_clients, data=data))


@pytest.mark.parametrize("avail", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_clients,data", [(1, 1), (3, 1), (8, 1), (4, 2),
                                            (2, 2), (3, 4), (1, 16)])
def test_cohort_mesh_clamps_data_first(avail, n_clients, data):
    """The data axis shrinks to the devices first, then the clients axis to
    what remains; a data axis of 1 leaves a 1-D mesh.  It never raises."""
    m = mesh.make_cohort_mesh(n_clients, data=data, devices=_cpus(avail))
    d = max(1, min(data, avail))
    c = max(1, min(n_clients, avail // d))
    want = {"clients": c} if d == 1 else {"clients": c, "data": d}
    assert dict(m.shape) == want and m.size == c * d
    assert all(dev == CPU for dev in m.devices.flat)


def test_host_mesh_equals_reference():
    _same(mesh.make_host_mesh(devices=_cpus(1)), j_mesh.make_host_mesh())
    for data, model in [(8, 1), (1, 8), (3, 3)]:
        _same(mesh.make_host_mesh(data, model, strict=False,
                                  devices=_cpus(1)),
              j_mesh.make_host_mesh(data, model, strict=False))
        with pytest.raises(RuntimeError, match="devices"):
            mesh.make_host_mesh(data, model, devices=_cpus(1))
        with pytest.raises(RuntimeError, match="devices"):
            j_mesh.make_host_mesh(data, model)
    m = mesh.make_host_mesh(data=9, model=2, strict=False, devices=_cpus(8))
    assert dict(m.shape) == {"data": 4, "model": 2}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    m = mesh.make_production_mesh(multi_pod=multi_pod,
                                  devices=[torch.device("meta")] * n)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert dict(m.shape) == want and m.devices.shape == tuple(want.values())
    with pytest.raises(RuntimeError, match="devices"):
        mesh.make_production_mesh(multi_pod=multi_pod, devices=_cpus(n - 1))
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        j_mesh.make_production_mesh(multi_pod=multi_pod)


def test_builders_without_devices_take_the_cards(monkeypatch):
    """No ``devices=``: the visible CUDA cards, and without CUDA a
    RuntimeError (a mesh on the CPU has to be asked for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (mesh.make_cohort_mesh, mesh.make_host_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = mesh.make_cohort_mesh(8)
    assert list(m.devices) == [torch.device("cuda", i) for i in range(3)]


def test_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)


_SPECS = ["auto", "AUTO", "4x2", "8x1", "8", "auto x2", "autox2", "4x2x1",
          "", "x", "abc", "-1", ("auto", 2), (4, 2), [2, 1], ("auto",),
          (1, 2, 3), 3, 2.5]


@pytest.mark.parametrize("spec", _SPECS, ids=repr)
def test_parse_mesh_spec_equals_reference(spec):
    try:
        want = j_cohort.parse_mesh_spec(spec)
    except Exception as e:          # noqa: BLE001
        with pytest.raises(type(e)):
            cohort.parse_mesh_spec(spec)
        return
    assert cohort.parse_mesh_spec(spec) == want


@pytest.mark.parametrize("spec", [None, "auto", "AUTO", "4x2", "8",
                                  ("auto", 2), (4, 2), "2x1"], ids=repr)
@pytest.mark.parametrize("cohort_size", [1, 3])
def test_resolve_cohort_mesh_equals_reference(spec, cohort_size):
    got = cohort.resolve_cohort_mesh(spec, cohort_size, devices=_cpus(1))
    want = j_cohort.resolve_cohort_mesh(spec, cohort_size)
    if spec is None:
        assert got is None and want is None
        return
    _same(got, want)
    named = cohort.resolve_cohort_mesh(spec, cohort_size, "c", "d",
                                       devices=_cpus(4))
    assert named.axis_names[0] == "c"
    given = mesh.make_cohort_mesh(2, devices=_cpus(2))
    assert cohort.resolve_cohort_mesh(given, cohort_size) is given


def test_axis_devices_orders_blocks_row_major():
    devs = np.asarray([torch.device("cpu", i) for i in range(8)],
                      dtype=object).reshape(2, 2, 2)
    m = mesh.Mesh(devs, ("a", "b", "c"))
    idx = lambda ds: [d.index for d in ds]  # noqa: E731
    assert idx(axis_devices(m, ("a", "b", "c"))) == list(range(8))
    assert idx(axis_devices(m, ("c",))) == [0, 1]
    assert idx(axis_devices(m, ("a", "c"))) == [0, 1, 4, 5]
    assert idx(axis_devices(m, ("c", "a"))) == [0, 4, 1, 5]


def _xlstm():
    cfg = reduced(get_config("xlstm-125m"), d_model=64)
    cfg = dataclasses.replace(cfg, n_layers=2, stages=(Stage(
        (LayerSpec(kind="mlstm", ffn="none"),
         LayerSpec(kind="slstm", ffn="none")), 1),))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, params


def _runtime(shape, names, batch_axes):
    m = mesh.Mesh(np.asarray(_cpus(int(np.prod(shape))),
                             dtype=object).reshape(shape), names)
    size = int(np.prod([m.shape[a] for a in batch_axes]))
    return Runtime(mesh=m, batch_axes=batch_axes, batch_axis_size=size)


@pytest.mark.parametrize("layout", [((2,), ("data",), ("data",)),
                                    ((4,), ("data",), ("data",)),
                                    ((2, 2), ("data", "model"), ("data",)),
                                    ((2, 2), ("data", "model"),
                                     ("data", "model"))])
def test_sharded_slstm_scan_equals_unsharded(layout):
    """The forward's logits, and the loss gradient of every sLSTM weight,
    over 2 or 4 batch shards, equal the unsharded scan's."""
    cfg, params = _xlstm()
    rt = _runtime(*layout)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 13), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for name, runtime in (("one", Runtime()), ("sharded", rt)):
        p = {k: v for k, v in params.items()}
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.grad = None
            leaf.requires_grad_(True)
        logits, _ = tfm.forward(p, {"tokens": toks}, cfg, runtime)
        loss, _ = tfm.loss_fn(p, batch, cfg, runtime)
        loss.backward()
        core = p["stages"][0]["l1"]["core"]
        out[name] = (logits.detach(), loss.detach(),
                     {k: core[k].grad.clone()
                      for k in ("w_gates", "r_gates", "b_gates")})
    torch.testing.assert_close(out["sharded"][0], out["one"][0], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out["sharded"][1], out["one"][1], rtol=0,
                               atol=1e-5)
    for k, g in out["one"][2].items():
        assert bool(g.abs().max() > 0), k
        torch.testing.assert_close(out["sharded"][2][k], g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()))


def test_sharded_slstm_block_state_and_fallback():
    """The block's new state is the unsharded one's; a batch the axes do
    not divide takes the unsharded scan, as in the reference."""
    cfg, params = _xlstm()
    core = tree_map(lambda a: a[0], params["stages"][0]["l1"]["core"])
    x = torch.randn((6, 9, 64), generator=torch.Generator().manual_seed(2))
    want, want_state = xlstm.slstm_forward(core, x, cfg=cfg)
    for shape, ok in (((2,), True), ((3,), True), ((4,), False)):
        rt = _runtime(shape, ("data",), ("data",))
        got, state = xlstm.slstm_forward(core, x, cfg=cfg, runtime=rt)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        for k in want_state:
            torch.testing.assert_close(state[k], want_state[k], rtol=0,
                                       atol=1e-5)
        if not ok:
            assert torch.equal(got, want)
