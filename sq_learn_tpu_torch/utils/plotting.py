"""Rendering of the runtime models' cost surfaces (the reference plots
them through the MATLAB engine, ``_dmeans.py:1451-1469``,
``_qPCA.py:1279-1315``). matplotlib is imported only when a figure is
asked for: nothing else in the package needs it."""


def plot_runtime_surfaces(nn, mm, quantum, classical, saveas, title=None):
    """Render the quantum and classical cost surfaces over an (n, m) mesh
    into the file ``saveas``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(nn, mm, quantum, label="quantumRuntime")
    ax.plot_surface(nn, mm, classical, label="classicRuntime")
    ax.set_xlabel("nSamples")
    ax.set_ylabel("nFeatures")
    if title:
        ax.set_title(title)
    fig.savefig(saveas)
    plt.close(fig)
