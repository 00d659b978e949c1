"""batrack_tpu_torch.geometry.so3 and .sim3 (SO3, RxSO3, Sim3), and the
rest of se3 (adjoints, left Jacobians, SE3, cat/stack), against
batrack_tpu's on the same seeded elements, float64 at 1e-9 with JAX under
jax.enable_x64(True): exp, log, mul, inv, act (3- and 4-vectors), matrix,
adj/adjT and retr, through the functions and the wrapper classes. The
tangents include the small-angle and zero-scale series (|phi| < 1e-3,
sigma = 0) and keep |phi| < pi, where log is the principal branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batrack_tpu.geometry import sim3 as jsim3
from batrack_tpu.geometry import so3 as jso3
from batrack_tpu_torch.geometry import RxSO3, SO3, Sim3, sim3, so3

N = 64


def tangents(dim, seed):
    """(N, dim) float64 tangents: rotation part |phi| < 3, rows 0-7 with
    |phi| < 1e-3, rows 8-15 with a zero scale part (dim > 3)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(N, dim))
    rot = slice(0, 3) if dim in (3, 4) else slice(3, 6)
    phi = xi[:, rot]
    phi *= np.minimum(1.0, 3.0 / np.linalg.norm(phi, axis=-1, keepdims=True))
    phi[:8] *= 1e-4
    xi[:, rot] = phi
    if dim in (4, 7):
        xi[8:16, -1] = 0.0
        xi[:, -1] *= 0.5
    return xi


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def T(x):
    return torch.from_numpy(np.asarray(x, np.float64))


GROUPS = {
    "so3": (3, so3.exp, so3.log, so3.mul, so3.inv, so3.act, so3.matrix,
            jso3.exp, jso3.log, jso3.mul, jso3.inv, jso3.act, jso3.matrix),
    "rxso3": (4, sim3.rxso3_exp, sim3.rxso3_log, sim3.rxso3_mul, sim3.rxso3_inv,
              sim3.rxso3_act, sim3.rxso3_matrix, jsim3.rxso3_exp, jsim3.rxso3_log,
              jsim3.rxso3_mul, jsim3.rxso3_inv, jsim3.rxso3_act, jsim3.rxso3_matrix),
    "sim3": (7, sim3.sim3_exp, sim3.sim3_log, sim3.sim3_mul, sim3.sim3_inv, sim3.sim3_act,
             sim3.sim3_matrix, jsim3.sim3_exp, jsim3.sim3_log, jsim3.sim3_mul, jsim3.sim3_inv,
             jsim3.sim3_act, jsim3.sim3_matrix),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_group_functions_match_jax(group):
    dim, exp, log, mul, inv, act, matrix, jexp, jlog, jmul, jinv, jact, jmatrix = GROUPS[group]
    a, b = tangents(dim, 1), tangents(dim, 2)
    p = np.random.default_rng(3).normal(size=(N, 3))
    ga, gb = exp(T(a)), exp(T(b))
    ja, jb = jexp(jnp.asarray(a)), jexp(jnp.asarray(b))
    close(ga, ja)
    close(log(ga), jlog(ja))
    close(log(ga), a)  # the round trip, principal branch
    close(mul(ga, gb), jmul(ja, jb))
    close(inv(ga), jinv(ja))
    close(act(ga, T(p)), jact(ja, jnp.asarray(p)))
    close(matrix(ga), jmatrix(ja))


def test_so3_adjoints_and_retr_match_jax():
    a, b = tangents(3, 4), tangents(3, 5)
    q, jq = so3.exp(T(a)), jso3.exp(jnp.asarray(a))
    v = tangents(3, 6)
    close(so3.adj(q, T(v)), jso3.adj(jq, jnp.asarray(v)))
    close(so3.adjT(q, T(v)), jso3.adjT(jq, jnp.asarray(v)))
    close(so3.retr(q, T(b)), jso3.retr(jq, jnp.asarray(b)))
    close(so3.from_matrix(so3.matrix(q)), jso3.from_matrix(jso3.matrix(jq)))
    close(so3.identity((2,), torch.float64), jso3.identity((2,), jnp.float64))


def test_sim3_act4_retr_identity_match_jax():
    a, b = tangents(7, 7), tangents(7, 8)
    g, jg = sim3.sim3_exp(T(a)), jsim3.sim3_exp(jnp.asarray(a))
    p4 = np.concatenate([np.random.default_rng(9).normal(size=(N, 3)), np.full((N, 1), 0.5)], -1)
    close(sim3.sim3_act4(g, T(p4)), jsim3.sim3_act4(jg, jnp.asarray(p4)))
    close(Sim3(g).retr(T(b)).data, jsim3.Sim3(jg).retr(jnp.asarray(b)).data)
    close(sim3.sim3_identity((3,), torch.float64), jsim3.sim3_identity((3,), jnp.float64))
    close(sim3.rxso3_identity((3,), torch.float64), jsim3.rxso3_identity((3,), jnp.float64))


def test_wrapper_classes_match_jax():
    """The thin classes dispatch like the JAX package's: `*` with a group
    element composes, with points acts (Sim3 takes 3- and 4-vectors)."""
    a, b = tangents(7, 10), tangents(7, 11)
    p = np.random.default_rng(12).normal(size=(N, 3))
    p4 = np.concatenate([p, np.ones((N, 1))], -1)
    A, B = Sim3.exp(T(a)), Sim3.exp(T(b))
    JA, JB = jsim3.Sim3.exp(jnp.asarray(a)), jsim3.Sim3.exp(jnp.asarray(b))
    close((A * B).data, (JA * JB).data)
    close(A * T(p), JA * jnp.asarray(p))
    close(A * T(p4), JA * jnp.asarray(p4))
    close(A.inv().log(), JA.inv().log())
    close(A.matrix(), JA.matrix())
    r, s = tangents(4, 13), tangents(4, 14)
    R, S = RxSO3.exp(T(r)), RxSO3.exp(T(s))
    JR, JS = jsim3.RxSO3.exp(jnp.asarray(r)), jsim3.RxSO3.exp(jnp.asarray(s))
    close((R * S).vec(), (JR * JS).vec())
    close(R * T(p), JR * jnp.asarray(p))
    close(R.inv().log(), JR.inv().log())
    q, w = tangents(3, 15), tangents(3, 16)
    Q, JQ = SO3.exp(T(q)), jso3.SO3.exp(jnp.asarray(q))
    close((Q * SO3.exp(T(w))).data, (JQ * jso3.SO3.exp(jnp.asarray(w))).data)
    close(Q * T(p), JQ * jnp.asarray(p))
    close(Q.retr(T(w)).data, JQ.retr(jnp.asarray(w)).data)
    close(Q.adjT(T(p)), JQ.adjT(jnp.asarray(p)))
    assert SO3.Identity(2, dtype=torch.float64).data.shape == (2, 4)
    assert Sim3.Identity(dtype=torch.float64).data.shape == (8,)


def test_se3_adjoints_jacobians_and_class_match_jax():
    """The rest of the SE3 API: adjoint matrix and actions, the left
    Jacobians, the wrapper class, and the geometry package's cat/stack."""
    from batrack_tpu import geometry as jgeo
    from batrack_tpu.geometry import se3 as jse3
    from batrack_tpu_torch import geometry
    from batrack_tpu_torch.geometry import SE3, se3

    xi, v = tangents(6, 17), tangents(6, 18)
    g, jg = se3.exp(T(xi)), jse3.exp(jnp.asarray(xi))
    close(se3.adjoint_matrix(g), jse3.adjoint_matrix(jg))
    close(se3.adj(g, T(v)), jse3.adj(jg, jnp.asarray(v)))
    close(se3.adjT(g, T(v)), jse3.adjT(jg, jnp.asarray(v)))
    close(se3.left_jacobian(T(xi)), jse3.left_jacobian(jnp.asarray(xi)))
    close(se3.left_jacobian_inverse(T(xi)), jse3.left_jacobian_inverse(jnp.asarray(xi)))
    A, JA = SE3.exp(T(xi)), jse3.SE3.exp(jnp.asarray(xi))
    close((A * A.inv()).data, (JA * JA.inv()).data)
    close(A.adjT(T(v)), JA.adjT(jnp.asarray(v)))
    close(A[:3].matrix(), JA[:3].matrix())
    assert A.shape == (N,)
    close(geometry.cat([A, A]).data, jgeo.cat([JA, JA]).data)
    close(geometry.stack([A, A], dim=1).data, jgeo.stack([JA, JA], axis=1).data)
