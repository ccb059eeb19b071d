import time

PROCESS_START = time.perf_counter()

if __name__ == "__main__":
    from portbench.run import main

    raise SystemExit(main(process_start=PROCESS_START))
