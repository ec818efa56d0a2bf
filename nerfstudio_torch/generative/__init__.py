"""Score-distillation guidance for text-to-3D (counterpart of
``nerfstudio_tpu/generative``): the diffusion schedules and SDS math, the
view-dependent prompts, the guidance facade with its weights-free stub, and
the Stable Diffusion and DeepFloyd IF wrappers."""
