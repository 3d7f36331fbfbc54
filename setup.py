from setuptools import find_packages, setup

setup(
    name="ground-plane-polling-tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas) monocular 3D object detection "
                 "with ground-plane polling"),
    packages=find_packages(exclude=("tests",)),
    # the PyTorch port's CUDA sources, compiled at first use
    package_data={"ground_plane_polling_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "scipy", "Pillow"],
    entry_points={
        "console_scripts": [
            "gpp-tpu-train=ground_plane_polling_tpu.bin.train:main",
            "gpp-tpu-debug=ground_plane_polling_tpu.bin.debug:main",
            "gpp-tpu-convert-model="
            "ground_plane_polling_tpu.bin.convert_model:main",
            "gpp-tpu-run-network="
            "ground_plane_polling_tpu.bin.run_network:main",
            "gpp-tpu-evaluate="
            "ground_plane_polling_tpu.bin.evaluate:main",
            "gpp-tpu-evaluate-3d="
            "ground_plane_polling_tpu.bin.evaluate_3d:main",
            "gpp-tpu-prepare-data="
            "ground_plane_polling_tpu.bin.prepare_data:main",
            "gpp-tpu-logs-to-tb="
            "ground_plane_polling_tpu.bin.logs_to_tb:main",
            "gpp-tpu-serve="
            "ground_plane_polling_tpu.bin.serve:main",
            "gpp-torch-run-network="
            "ground_plane_polling_tpu_torch.bin.run_network:main",
        ],
    },
)
