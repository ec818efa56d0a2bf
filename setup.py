from setuptools import find_packages, setup

setup(
    name="nerfstudio_tpu",
    version="0.1.0",
    description="TPU-native neural rendering framework (nerfstudio-class) on JAX/XLA/Pallas",
    packages=find_packages(include=["nerfstudio_tpu*", "nerfstudio_torch*"]),
    package_data={"nerfstudio_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            "nst-train=nerfstudio_tpu.scripts.train:entrypoint",
            "nst-eval=nerfstudio_tpu.scripts.eval:entrypoint",
            "nst-render=nerfstudio_tpu.scripts.render:entrypoint",
            "nst-export=nerfstudio_tpu.scripts.exporter:entrypoint",
            "nst-download-data=nerfstudio_tpu.scripts.downloads.download_data:entrypoint",
            "nst-process-data=nerfstudio_tpu.scripts.process_data:entrypoint",
            "nst-install-completions=nerfstudio_tpu.scripts.completions.install:entrypoint",
            "nst-viewer=nerfstudio_tpu.scripts.viewer_script:entrypoint",
        ],
    },
)
