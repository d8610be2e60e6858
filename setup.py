from setuptools import setup, find_packages
import hicpeaks_tpu

setup(
    name='hicpeaks-tpu',
    version=hicpeaks_tpu.__version__,
    description='Accelerated Hi-C loop calling (HiCCUPS / BH-FDR) on JAX',
    packages=find_packages(exclude=['tests', 'tests.*']),
    scripts=['scripts/toCooler', 'scripts/pyBHFDR', 'scripts/pyHICCUPS',
             'scripts/combine-resolutions', 'scripts/peak-plot',
             'scripts/apa-analysis'],
    python_requires='>=3.10',
    install_requires=['numpy', 'scipy', 'h5py', 'jax'],
)
