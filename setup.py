from setuptools import setup, find_packages

from vilma_tpu import VERSION

setup(
    name='vilma_tpu',
    version=VERSION,
    description='JAX variational inference of variant effect sizes '
                'and effect-size distributions from GWAS summary data',
    packages=find_packages(exclude=('tests',)),
    python_requires='>=3.10',
    install_requires=[
        'jax',
        'numpy',
        'ml_dtypes',
    ],
    extras_require={
        # gradient-/MCMC-based posterior validation tooling
        'validation': ['optax'],
    },
    entry_points={
        'console_scripts': ['vilma-tpu=vilma_tpu.frontend:main'],
    },
)
