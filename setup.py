from setuptools import setup, find_packages

setup(
    name='nnest_tpu',
    version='0.1.0',
    description=('TPU-native neural nested sampling and MCMC '
                 '(JAX/XLA rebuild of nnest), with its PyTorch/CUDA port'),
    packages=find_packages(include=['nnest_tpu', 'nnest_tpu.*',
                                    'nnest_torch', 'nnest_torch.*']),
    package_data={'nnest_tpu.runtime': ['src/*.cpp'],
                  'nnest_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'jax',
        'numpy',
        'optax',
        'scipy',
    ],
    extras_require={
        'plots': ['matplotlib', 'getdist'],
        'tensorboard': ['torch'],
        'torch': ['torch'],
        'test': ['pytest'],
    },
    license='MIT',
)
