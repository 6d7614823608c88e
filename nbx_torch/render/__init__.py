"""The frame renderer (port of `nbx/render/`): point splats, ribbon trails,
particles, flash lights, sphere impostors, bloom and tonemap, composed by
`pipeline.render_and_advance` / `render_granular`, and the host-side viewer
(`viewer`: PNG frames, the HTML player) and camera paths (`campath`).

Every pass is eager PyTorch on the tensors' device, in float32, and reads
nothing back to the host: a frame is a chain of kernel launches ending in one
[H, W, 3] image. Scatter-adds go through `splat.scatter_add` (the JAX
package's `.at[...].add(mode="drop")`), whose CUDA accumulation uses atomics:
a card's frame agrees with the CPU's to float32 summation order.
"""
