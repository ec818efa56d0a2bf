"""generfacto's training trajectory under the stub guidance, JAX package
against the port, on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/generfacto_trajectory_vs_jax.py STEPS EVERY [name=value ...]

Both sides train in one process (so one stub colour: Python salts
``hash(prompt)`` per process) from JAX's init, the port taking JAX's draws
of every step (``train_step``'s k1 and k2, as JAX splits its key), and
print, every EVERY steps and at step 0, one JSON line: per side the step's
loss and eval view 0's distances to the stub's colour
(``chip_smoke.colour_gaps``: the mean rgb where accumulation > 0.5, those
pixels, the field's own colour, the mean accumulation). Names: ``prompt``,
``res`` (train and eval resolution, 16), ``samples`` (per ray, 16),
``seed`` (0), ``float32_mlps`` (1: every MLP in float32 on both sides) and
the field's ``num_levels``, ``base_res``, ``max_res``,
``log2_hashmap_size``, ``hidden_dim`` (patched into both packages'
generfacto; the shipped field where not given). Not a test: a witness of
whether the port follows the reference's trajectory, and of where the
stub's pull on the colour goes."""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

FIELD_NAMES = ("num_levels", "base_res", "max_res", "log2_hashmap_size", "hidden_dim")


def main(argv):
    import chip_smoke
    import nerfstudio_tpu.field_components.mlp as jmlp
    import nerfstudio_tpu.fields.nerfacto_field as jfield
    import nerfstudio_tpu.models.generfacto as jgen_mod
    import nerfstudio_tpu.pipelines.generative_pipeline as jpipe_mod
    import nerfstudio_torch.models.generfacto as tgen_mod
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.data.random_cameras_datamanager import RandomCamerasConfig as JCams
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.random_cameras_datamanager import RandomCamerasConfig
    from nerfstudio_torch.field_components.mlp import MLP
    from nerfstudio_torch.fields.nerfacto_field import NerfactoField
    from nerfstudio_torch.models.generfacto import GenerfactoDraws
    from nerfstudio_torch.pipelines.generative_pipeline import GenerativeDraws, GenerativePipeline
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    steps, every = int(argv[0]), int(argv[1])
    opts = dict(a.split("=", 1) for a in argv[2:])
    res, samples, seed = int(opts.get("res", 16)), int(opts.get("samples", 16)), int(opts.get("seed", 0))
    field = {k: int(opts[k]) for k in FIELD_NAMES if k in opts}
    if "hidden_dim" in field:
        field["hidden_dim_color"] = field["hidden_dim"]
    jgen_mod.NerfactoField = functools.partial(jfield.NerfactoField, **field)
    tgen_mod.NerfactoField = functools.partial(NerfactoField, **field)
    if int(opts.get("float32_mlps", 1)):
        jfield.MLP, jmlp.MLP = (functools.partial(c, dtype=jnp.float32) for c in (jfield.MLP, jmlp.MLP))

    jcfg, tcfg = jget_method("generfacto"), get_method("generfacto")
    for cfg, cams in ((jcfg, JCams), (tcfg, RandomCamerasConfig)):
        cfg.model.num_samples_per_ray = samples
        cfg.model.prompt = opts.get("prompt", cfg.model.prompt)
        cfg.random_cameras = cams(train_resolution=res, eval_resolution=res)
    jpipe = jpipe_mod.GenerativePipeline(jcfg, seed=seed)
    jstate = jpipe.init_state(jax.random.PRNGKey(seed))
    pipe = GenerativePipeline(tcfg, seed=seed, device="cpu")
    state = pipe.init_state()
    pipe.restore(state, trainer_checkpoint_from_jax(jax.device_get(jstate), pipe.model, state.optimizer))
    if int(opts.get("float32_mlps", 1)):
        for m in pipe.model.modules():
            if isinstance(m, MLP):
                m.dtype = torch.float32
    target = pipe.text_embedding
    assert np.array_equal(np.asarray(jpipe.text_embedding), target.numpy())

    def gaps(out):
        return chip_smoke.colour_gaps({k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}, target)

    key = jax.random.PRNGKey(seed)
    losses = {"jax": None, "torch": None}
    for step in range(steps + 1):
        if step % every == 0:
            print(json.dumps({"step": step, "target": target.tolist(),
                              "jax": dict(loss=losses["jax"], gaps=gaps(jpipe.render_eval_image(jstate, 0))),
                              "torch": dict(loss=losses["torch"], gaps=gaps(pipe.render_eval_image(state, 0)))}),
                  flush=True)
        if step == steps:
            break
        key, k = jax.random.split(key)
        jstate, jm = jpipe.train_step(jstate, step, k)
        k1, k2, _ = jax.random.split(k, 3)
        k_s, k_bg, _ = jax.random.split(k1, 3)
        draws = GenerativeDraws(GenerfactoDraws(jitter=torch.from_numpy(np.asarray(jax.random.uniform(k_s, (res * res, 1)))),
                                                background=torch.from_numpy(np.asarray(jax.random.uniform(k_bg, (res * res, 3))))),
                                sds_noise=torch.from_numpy(np.asarray(jax.random.normal(k2, (res, res, 3)))))
        tm = pipe.train_step(state, step, draws=draws)
        losses = {"jax": float(jm["loss"]), "torch": float(tm["loss"])}


if __name__ == "__main__":
    main(sys.argv[1:])
