"""The paper's experiment through the port: the counterparts of the
reference's ``benchmarks/`` scripts for Tab. I and Figs. 3-6, under the
same file names, printing the same ``tab1/``, ``fig3/`` ... ``fig6/`` lines.

    python -m repro_torch.paper.run --datasets RAND10M4D --only fig4,fig6 --device cpu
"""
