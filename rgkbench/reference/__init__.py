"""The benchmark's plain reference: the renderer's per-sample path as
plain PyTorch, frozen in this folder (scene loading, sampler, shading,
lights, textures, the integrator's per-sample path and the gradient
view of a scene), with its own ray queries, every ray against every
triangle (`ops/intersect.py`).  It imports neither JAX nor the JAX
package nor the renderer under test, and takes nothing that the
renderer made: it reads the scene's files and works every table out
again.
"""
