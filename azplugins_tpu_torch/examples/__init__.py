"""The nine examples of the JAX package (``examples/`` at the repository
root), as the port's own copies: the same physics, sizes, printed output
and ``AZTPU_EXAMPLE_FAST=1`` smoke mode, on ``azplugins_tpu_torch``. Each
module's ``main(device=None)`` runs on the GPU unless the caller asks for
the CPU (``main(device="cpu")``)::

    AZTPU_EXAMPLE_FAST=1 python -m azplugins_tpu_torch.examples.lj_fluid

runs one on the GPU; ``python -c "from azplugins_tpu_torch.examples import
lj_fluid; lj_fluid.main(device='cpu')"`` on the CPU. ``FAST`` is read when a
module is imported.
"""

EXAMPLES = (
    "lj_fluid", "polymer_melt", "kremer_grest_melt", "dpd_fluid", "patchy_particles",
    "droplet_evaporation", "poiseuille_flow", "mpcd_poiseuille", "colloid_hydrodynamics",
)
