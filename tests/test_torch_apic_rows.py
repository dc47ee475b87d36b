"""The APIC particle-to-grid scatter in its row form
(``ops/apic.py:apic_sums``: per component one (N, 16|8) row of the 8 (2D:
4) corners' w * v and w, summed by one ``core/interp.py:add_at``), against
the JAX package's ``apic_map_parts_to_mac`` at the flat p2g's 1e-5 and
against the 48 one-column scatters it replaced (``index_add_`` per corner,
channel and component) at 1e-5: the same products, summed in another
order (the sums reach tens). Particles are the JAX package's dam
sampling; velocities and affine rows come from a numpy seed. The repeat
on the card is ``tests/test_torch_card_repairs.py``'s."""

import numpy as np
import pytest
import torch

from mantaflow_tpu.core.particles import Particles as JParticles
from mantaflow_tpu.ops import apic as jao
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.particles import pos_columns
from mantaflow_tpu_torch.models import flip
from mantaflow_tpu_torch.ops import apic as ao


def _inputs(size, dim, seed=3):
    dom = Domain(size=size, dim=dim)
    st = flip.make_dam_state(dom, flip.FlipParams(apic=True),
                             discretization=2, device="cpu")
    rs = np.random.RandomState(seed)
    cap = st.parts.capacity
    pv, cx, cy, cz = (torch.from_numpy(rs.uniform(-1.0, 1.0, (cap, 3))
                                       .astype(np.float32)) for _ in range(4))
    if dim == 2:
        pv[:, 2] = 0.0
    return dom, st, pv, cx, cy, cz


def _corner_scatters(parts, pvel, cps, dom):
    """The replaced form: one index_add_ per corner, channel and
    component."""
    sz, sy, sx = dom.shape
    af = parts.active_mask().to(torch.float32)
    px, py, pz = pos_columns(parts.pos)
    vels, masses = [], []
    for c in range(3):
        acc = torch.zeros(dom.num_cells)
        mass = torch.zeros(dom.num_cells)
        if c < (3 if dom.is3d else 2):
            (i0, j0, k0), (wx1, wy1, wz1), (gx, gy, gz) = ao._apic_weights(
                parts.pos, dom, c)
            cp0, cp1, cp2 = pos_columns(cps[c])
            for di in (0, 1):
                for dj in (0, 1):
                    for dk in ((0, 1) if dom.is3d else (0,)):
                        w = ((wx1 if di else 1.0 - wx1)
                             * (wy1 if dj else 1.0 - wy1)
                             * ((wz1 if dk else 1.0 - wz1) if dom.is3d
                                else 1.0) * af)
                        val = (pvel[:, c] + cp0 * (gx + di - px)
                               + cp1 * (gy + dj - py) + cp2 * (gz + dk - pz))
                        flat = (((k0 + dk) * sy + (j0 + dj)) * sx
                                + (i0 + di)).long()
                        acc.index_add_(0, flat, w * val)
                        mass.index_add_(0, flat, w)
        vels.append(acc.reshape(dom.shape))
        masses.append(mass.reshape(dom.shape))
    return torch.stack(vels), torch.stack(masses)


@pytest.mark.parametrize("size,dim", [((16, 16, 16), 3), ((24, 24, 1), 2)])
def test_apic_rows_match_reference_and_the_corner_scatters(size, dim):
    dom, st, pv, cx, cy, cz = _inputs(size, dim)
    vel, mass = ao.apic_map_parts_to_mac(st.parts, pv, cx, cy, cz, st.flags,
                                         dom)
    jparts = JParticles(pos=st.parts.pos.numpy(), flags=st.parts.flags.numpy(),
                        count=st.parts.count.numpy())
    jvel, jmass = jao.apic_map_parts_to_mac(
        jparts, pv.numpy(), cx.numpy(), cy.numpy(), cz.numpy(),
        st.flags.numpy(), JDomain(size=size, dim=dim))
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), atol=1e-5,
                               rtol=0)
    acc, msum = ao.apic_sums(st.parts, pv, cx, cy, cz, dom)
    old_acc, old_mass = _corner_scatters(st.parts, pv, (cx, cy, cz), dom)
    np.testing.assert_allclose(acc.numpy(), old_acc.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(msum.numpy(), old_mass.numpy(), atol=1e-5,
                               rtol=0)
    assert float(mass.sum()) > 0

